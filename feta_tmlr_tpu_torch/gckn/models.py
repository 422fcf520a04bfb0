"""GCKN models: the unsupervised path-kernel encoder, the supervised GCKN
network, and the encoder's codes as the transformers' positional input.

The counterparts of the JAX package's `gckn/models.py` (the reference's
`PathSequential` / `GCKNetFeature` and `GCKNet`, gckn/models.py, and
transformer/gckn_pe.py). The JAX package picks devices by measured
thresholds and environment variables; here they are arguments: `device`
(where `encode` and the layers between k-means runs go; CUDA unless the
caller passes "cpu", and no fallback to the CPU) and `kmeans_impl`
("numpy", the default, on the host as in JAX; or "torch" on `device`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from feta_tmlr_tpu_torch.data.batch import Graph
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.gckn.layer import (
    PathLayerParams,
    init_path_layer,
    path_layer_forward,
    sample_paths,
    unsup_train_layer,
)
from feta_tmlr_tpu_torch.gckn.paths import PathBatch, build_path_batch
from feta_tmlr_tpu_torch.ops.segment import segment_sum


@dataclasses.dataclass
class GCKNFeature:
    """Multi-layer GCKN encoder with k-means pretraining."""

    layers: List[PathLayerParams]
    path_sizes: List[int]
    aggregation: bool = False

    @classmethod
    def create(cls, input_size: int, hidden_sizes: Sequence[int],
               path_sizes: Sequence[int], kernel_args=0.5,
               pooling: str = "mean", aggregation: bool = False,
               seed: int = 0) -> "GCKNFeature":
        """Random anchors from a torch generator seeded with `seed` (k-means
        replaces them: `unsup_train`)."""
        g = torch.Generator().manual_seed(seed)
        if not isinstance(kernel_args, (list, tuple)):
            kernel_args = [kernel_args] * len(hidden_sizes)
        layers, in_size = [], input_size
        for i, (h, s) in enumerate(zip(hidden_sizes, path_sizes)):
            layers.append(init_path_layer(
                g, in_size, h, s, kernel_arg=kernel_args[i],
                pooling=pooling, aggregation=aggregation))
            in_size = h
        return cls(layers=layers, path_sizes=list(path_sizes),
                   aggregation=aggregation)

    @property
    def max_path_size(self) -> int:
        return max(self.path_sizes)

    def unsup_train(self, graphs: Sequence[Graph],
                    n_sampling_paths: int = 100000, seed: int = 0,
                    device=None, kmeans_impl: str = "numpy") -> PathBatch:
        """k-means pretraining of every layer over the graphs' enumerated
        paths; returns the path batch. Layer i + 1 samples from layer i's
        output, computed on `device`."""
        batch = build_path_batch(graphs, self.max_path_size)
        dev = None
        if len(self.layers) > 1 or kmeans_impl == "torch":
            dev = resolve_device(device)
        features = batch.features
        for i, layer in enumerate(self.layers):
            paths = sample_paths(layer, features, batch, n_sampling_paths,
                                 seed=seed + i)
            self.layers[i] = unsup_train_layer(layer, paths, seed=seed + i,
                                               kmeans_impl=kmeans_impl,
                                               device=dev)
            if i + 1 < len(self.layers):
                # the next layer samples from these features; after the
                # last layer the whole forward would be dead work
                with torch.no_grad():
                    features = path_layer_forward(
                        self.layers[i], torch.as_tensor(features,
                                                        device=dev), batch)
        return batch

    def encode(self, graphs: Sequence[Graph],
               batch: Optional[PathBatch] = None, device=None,
               chunk_graphs: Optional[int] = None,
               dtype: torch.dtype = torch.float32) -> List[np.ndarray]:
        """Per-node codes, one [n_i, output_dim] array per graph, computed
        on `device` in `dtype`. chunk_graphs: slices of this many graphs,
        each with its own path batch (a working set bounded by the
        slice)."""
        dev = resolve_device(device)
        if chunk_graphs and len(graphs) > chunk_graphs:
            out = []
            for i in range(0, len(graphs), chunk_graphs):
                out.extend(self.encode(graphs[i:i + chunk_graphs],
                                       device=dev, dtype=dtype))
            return out
        if batch is None:
            batch = build_path_batch(graphs, self.max_path_size)
        with torch.no_grad():
            features = torch.from_numpy(batch.features).to(dev, dtype)
            for layer in self.layers:
                features = path_layer_forward(layer, features, batch)
        flat = features[:-1].reshape(features.shape[0] - 1, -1)
        flat = flat.cpu().numpy()                  # drop the dummy row
        out, off = [], 0
        for n in batch.graph_n_nodes:
            out.append(flat[off:off + n])
            off += n
        return out

    @property
    def output_dim(self) -> int:
        q = 1
        for layer, s in zip(self.layers, self.path_sizes):
            if layer.aggregation:
                q *= s
        return q * self.layers[-1].hidden_size


class GCKNSupervised(nn.Module):
    """The supervised GCKN network (the reference's GCKNet,
    experiments/gckn_sup.py): path layers -> mean over each graph's nodes
    -> batch normalisation -> linear classifier, trained end to end,
    optionally from a k-means init.

    Parameters (the JAX package's dict keys): `layer_<i>_weight` (the
    path layers' anchors), `bn_scale`, `bn_bias`, `classifier_w` [d,
    classes] (numpy's draws from `seed`, as JAX's), `classifier_b`. The
    normalisation uses the batch's own statistics (population variance +
    1e-5) unless `bn_stats` (`compute_bn_stats`) are given, as JAX's does;
    it is not `nn.BatchNorm1d`."""

    def __init__(self, input_size, hidden_sizes, path_sizes, n_classes,
                 kernel_args=0.5, pooling="mean", aggregation=False,
                 seed=0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.feature = GCKNFeature.create(
            input_size, hidden_sizes, path_sizes, kernel_args, pooling,
            aggregation, seed)
        self.n_classes = n_classes
        rng = np.random.default_rng(seed)
        d = self.feature.output_dim
        self.classifier_w = nn.Parameter(torch.from_numpy(np.asarray(
            rng.standard_normal((d, n_classes)) / np.sqrt(d), np.float32)))
        self.classifier_b = nn.Parameter(torch.zeros(n_classes))
        self.bn_scale = nn.Parameter(torch.ones(d))
        self.bn_bias = nn.Parameter(torch.zeros(d))
        for i, layer in enumerate(self.feature.layers):
            self.register_parameter(f"layer_{i}_weight",
                                    nn.Parameter(layer.weight.clone()))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.classifier_w.device

    def unsup_init(self, graphs, n_sampling_paths=10000, seed=0,
                   kmeans_impl: str = "numpy") -> PathBatch:
        batch = self.feature.unsup_train(graphs, n_sampling_paths, seed,
                                         device=self.device,
                                         kmeans_impl=kmeans_impl)
        with torch.no_grad():
            for i, layer in enumerate(self.feature.layers):
                getattr(self, f"layer_{i}_weight").copy_(layer.weight)
        return batch

    def pooled_features(self, batch: PathBatch):
        """[n_graphs, d]: the mean of each graph's node codes (the
        reference's NodePooling)."""
        features = torch.from_numpy(batch.features).to(
            self.device, self.classifier_w.dtype)
        for i, layer in enumerate(self.feature.layers):
            features = path_layer_forward(
                layer, features, batch,
                weight=getattr(self, f"layer_{i}_weight"))
        flat = features.reshape(features.shape[0], -1)
        seg = torch.from_numpy(batch.node2graph).to(self.device)
        pooled = segment_sum(flat, seg, batch.n_graphs + 1,
                             indices_are_sorted=True)
        cnt = segment_sum(torch.ones_like(flat[:, 0]), seg,
                          batch.n_graphs + 1, indices_are_sorted=True)
        return (pooled / torch.clamp(cnt, min=1.0)[:, None]
                )[:batch.n_graphs]

    def compute_bn_stats(self, batch: PathBatch):
        """Frozen normalisation statistics (mean, var + 1e-5) of a
        (training) batch, for deterministic inference."""
        with torch.no_grad():
            pooled = self.pooled_features(batch)
        return pooled.mean(0), pooled.var(0, unbiased=False) + 1e-5

    def _normed(self, pooled, bn_stats):
        if bn_stats is None:
            mean = pooled.mean(0)
            var = pooled.var(0, unbiased=False) + 1e-5
        else:
            mean, var = bn_stats
        normed = (pooled - mean) / torch.sqrt(var)
        return normed * self.bn_scale + self.bn_bias

    def forward(self, batch: PathBatch, bn_stats=None):
        """Per-graph logits [n_graphs, n_classes]; without `bn_stats` the
        batch's own statistics (training mode)."""
        normed = self._normed(self.pooled_features(batch), bn_stats)
        return normed @ self.classifier_w + self.classifier_b

    def unsup_train_classifier(self, batch: PathBatch, labels,
                               alpha: float = 0.0, loss: str = "ce",
                               bn_stats=None):
        """Fit only the linear head by L-BFGS on the encoded features (the
        reference's GCKNet.unsup_train_classifier), in place."""
        from feta_tmlr_tpu_torch.gckn.linear import LinearClassifier

        with torch.no_grad():
            pooled = self.pooled_features(batch)
            if bn_stats is None:
                bn_stats = (pooled.mean(0),
                            pooled.var(0, unbiased=False) + 1e-5)
            feats = self._normed(pooled, bn_stats).cpu().numpy()
        clf = LinearClassifier(feats.shape[1], self.n_classes, alpha=alpha,
                               loss=loss).fit(feats, labels)
        with torch.no_grad():
            self.classifier_w.copy_(torch.from_numpy(clf.weight.T.copy()))
            self.classifier_b.copy_(torch.from_numpy(clf.bias))
        return self


def gckn_encode_as_pe(graphs: Sequence[Graph], dim: int = 32,
                      path_size: int = 3, standardize: bool = True,
                      n_sampling_paths: int = 100000,
                      aggregation: bool = False, kernel_arg: float = 0.5,
                      pooling: str = "mean", seed: int = 0, device=None,
                      kmeans_impl: str = "numpy") -> int:
    """GCKN codes as each graph's `lap_pe` (the reference's gckn_pe.py and
    GCKNEncoding.apply_to): k-means on the host (`kmeans_impl`), the
    encode on `device`, codes standardised over all nodes on the host.
    Returns the PE dimension."""
    model = GCKNFeature.create(
        input_size=graphs[0].x.shape[-1], hidden_sizes=[dim],
        path_sizes=[path_size], kernel_args=kernel_arg, pooling=pooling,
        aggregation=aggregation, seed=seed)
    batch = model.unsup_train(graphs, n_sampling_paths, seed=seed,
                              device=device, kmeans_impl=kmeans_impl)
    feats = model.encode(graphs, batch, device=device)
    return attach_codes(graphs, feats, standardize)


def attach_codes(graphs: Sequence[Graph], feats: Sequence[np.ndarray],
                 standardize: bool = True) -> int:
    """Each graph's codes as its `lap_pe` (float32), standardised over all
    nodes on the host (mean 0, std 1 + 1e-8 per column) unless told not
    to; returns their width."""
    if standardize:
        allf = np.concatenate(feats)
        mean, std = allf.mean(0), allf.std(0) + 1e-8
        feats = [(f - mean) / std for f in feats]
    for g, f in zip(graphs, feats):
        g.lap_pe = f.astype(np.float32)
    return feats[0].shape[-1]
