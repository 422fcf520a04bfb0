"""The GCKN path layer, functional.

The counterpart of the JAX package's `gckn/layer.py` (the reference's
`PathLayer`, gckn/layers.py). Forward (layers.py:88-148):
  1. row-normalise the anchors W [path_size, hidden, input];
  2. project: out = features . W / ||features||, per path position;
  3. per path size: path_conv (gather-mean) -> kappa -> per-node pooling;
  4. rescale by the node norms;
  5. multiply by lintrans = kappa(mean_j W_j W_j^T)^{-1/2} (the Nystrom
     normalisation; its cumulative variant in aggregation mode).

The batch's arrays go to the features' device once per batch and device
(`device_paths`), with a block plan per path size for `path_conv_agg`.
"""

from __future__ import annotations

import dataclasses
from functools import partial
import numpy as np
import torch

from feta_tmlr_tpu_torch.gckn.kmeans import (
    spherical_kmeans,
    spherical_kmeans_torch,
)
from feta_tmlr_tpu_torch.gckn.ops import (
    BLOCK_ROWS,
    EPS,
    KERNELS,
    matrix_inverse_sqrt,
    normalize_rows,
    path_blocks,
    path_conv_agg,
)
from feta_tmlr_tpu_torch.gckn.paths import PathBatch


@dataclasses.dataclass
class PathLayerParams:
    weight: torch.Tensor           # [path_size, hidden, input]
    path_size: int
    kernel_func: str = "exp"
    kernel_arg: float = 0.5        # sigma; alpha = 1/sigma^2 for exp
    pooling: str = "mean"
    aggregation: bool = False

    @property
    def alpha(self) -> float:
        if self.kernel_func == "exp":
            return 1.0 / self.kernel_arg ** 2
        return self.kernel_arg

    @property
    def hidden_size(self) -> int:
        return self.weight.shape[1]

    @property
    def input_size(self) -> int:
        return self.weight.shape[2]


def init_path_layer(generator: torch.Generator, input_size, hidden_size,
                    path_size, kernel_func="exp", kernel_arg=0.5,
                    pooling="mean", aggregation=False) -> PathLayerParams:
    """Anchors uniform in +-1/sqrt(hidden) from `generator`, rows
    normalised (float32, on the CPU)."""
    stdv = 1.0 / np.sqrt(hidden_size)
    w = torch.empty(path_size, hidden_size, input_size).uniform_(
        -stdv, stdv, generator=generator)
    return PathLayerParams(weight=normalize_rows(w), path_size=path_size,
                           kernel_func=kernel_func, kernel_arg=kernel_arg,
                           pooling=pooling,
                           aggregation=aggregation and path_size > 1)


def compute_lintrans(params: PathLayerParams, weight=None):
    """[H, H], or [S, H, H] in aggregation mode."""
    w = normalize_rows(params.weight if weight is None else weight)
    gram = torch.einsum("shd,sgd->shg", w, w)         # [S, H, H]
    kappa = KERNELS[params.kernel_func]
    if params.aggregation:
        divider = torch.arange(1, params.path_size + 1, dtype=w.dtype,
                               device=w.device)[:, None, None]
        gram = torch.cumsum(gram, 0) / divider
        return matrix_inverse_sqrt(kappa(gram, params.alpha))
    return matrix_inverse_sqrt(kappa(gram.mean(0), params.alpha))


def device_paths(batch: PathBatch, size: int, device):
    """(path_indices, segment_ids, path_mask, blocks) of the paths of
    `size` nodes on `device`, made once per batch, device and block size
    (`gckn/ops.py::path_blocks` of BLOCK_ROWS rows)."""
    key = (size, str(torch.device(device)), BLOCK_ROWS)
    if key not in batch.cache:
        i = size - 1
        ids = batch.segment_ids[i]
        blocks = path_blocks(ids, batch.n_nodes + 1, BLOCK_ROWS)
        batch.cache[key] = (
            torch.from_numpy(batch.path_indices[i]).to(device).long(),
            torch.from_numpy(ids).to(device).long(),
            torch.from_numpy(batch.path_mask[i]).to(device), blocks)
    return batch.cache[key]


def path_layer_forward(params: PathLayerParams, features, batch: PathBatch,
                       weight=None):
    """features: [V+1, F] (or [V+1, Q, F] for stacked layers) on any
    device; `weight` replaces params.weight (a trained parameter).

    Returns [V+1, Q * path_size (aggregation) or Q, hidden], the
    reference's layout."""
    raw = (params.weight if weight is None else weight).to(
        device=features.device, dtype=features.dtype)
    w = normalize_rows(raw)
    kappa = partial(KERNELS[params.kernel_func], alpha=params.alpha)

    if features.ndim == 2:
        features = features[:, None, :]            # [V+1, 1, F]
    v1, q, _ = features.shape
    hid = params.hidden_size
    norms = torch.linalg.vector_norm(features, dim=-1, keepdim=True)
    out = torch.einsum("vqf,shf->vsqh", features, w)
    out = out / torch.clamp(norms, min=EPS)[:, None, :, :]
    out = out.reshape(v1, params.path_size, q * hid)

    def agg(size):
        pi, si, pm, blocks = device_paths(batch, size, features.device)
        return path_conv_agg(out, pi, si, v1, pooling=params.pooling,
                             kappa=kappa, path_mask=pm, blocks=blocks)

    lintrans = compute_lintrans(params, raw)
    if params.aggregation:
        emb = torch.stack([agg(s) for s in range(1, params.path_size + 1)])
        emb = emb.reshape(params.path_size, v1 * q, hid)
        emb = norms.reshape(1, -1, 1) * emb
        emb = torch.einsum("svh,shg->svg", emb, lintrans)
        emb = emb.reshape(params.path_size, v1, q, hid)
        return emb.permute(1, 2, 0, 3).reshape(v1, q * params.path_size,
                                               hid)
    emb = agg(params.path_size).reshape(v1, q, hid)
    emb = norms * emb
    return torch.einsum("vqh,hg->vqg", emb, lintrans)


def sample_paths(params: PathLayerParams, features, batch: PathBatch,
                 n_sampling_paths: int = 1000, seed: int = 0):
    """Sampled path feature tensors for k-means (layers.py:150-172), the
    JAX package's draws from the same numpy seed."""
    rng = np.random.default_rng(seed)
    s = params.path_size
    feats = (features.detach().cpu().numpy() if torch.is_tensor(features)
             else np.asarray(features))
    if feats.ndim == 2:
        feats = feats[:, None, :]
    pi = batch.path_indices[s - 1]
    mask = batch.path_mask[s - 1]
    pi = pi[mask]
    if s == 1:
        flat = feats.transpose(1, 0, 2).reshape(-1, feats.shape[-1])
        n = min(len(flat), n_sampling_paths)
        idx = rng.permutation(len(flat))[:n]
        return flat[idx][:, None, :]
    n = min(pi.shape[0], n_sampling_paths)
    idx = rng.permutation(pi.shape[0])[:n]
    paths = feats[pi[idx]]                         # [n, s, Q, F]
    paths = paths.transpose(0, 2, 1, 3).reshape(-1, s, feats.shape[-1])
    return paths[:n]


def unsup_train_layer(params: PathLayerParams, paths, seed: int = 0,
                      kmeans_impl: str = "numpy",
                      device=None) -> PathLayerParams:
    """Spherical k-means over sampled paths -> anchors (layers.py:
    174-187): `kmeans_impl` "numpy" (the host loop) or "torch" (the
    Lloyd loop on `device`). The anchors stay on params.weight's device."""
    if kmeans_impl == "numpy":
        centers = spherical_kmeans(paths, params.hidden_size, seed=seed)
    elif kmeans_impl == "torch":
        centers = spherical_kmeans_torch(paths, params.hidden_size,
                                         seed=seed, device=device)
    else:
        raise ValueError(f"kmeans_impl {kmeans_impl!r}: 'numpy' or 'torch'")
    w = torch.from_numpy(centers).transpose(0, 1)  # [path_size, hidden, in]
    return dataclasses.replace(params, weight=normalize_rows(w).to(
        params.weight.device))
