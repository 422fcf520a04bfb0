"""Load the JAX package's flax variables into the port's modules.

`variables` is `{'params': ..., 'batch_stats': ...}` as nested dicts of
numpy arrays (`jax.tree.map(np.asarray, variables)` on the JAX side). The
port's module tree mirrors the flax one, so each torch parameter or buffer
names its flax leaf:

  - `layers.<i>` is flax's `layer_<i>`;
  - the OGB models' atom encoder `embedding.atom_emb_<i>` is flax's
    `embedding/atom_emb_<i>`, their head `cls_fc1` / `cls_fc2` flax's
    Dense layers of those names;
  - an `nn.Linear` weight is the flax Dense `kernel` transposed ([in, out]
    -> [out, in]); an `nn.LayerNorm` weight is the flax `scale`; an
    `nn.Embedding` weight is the flax Embed `embedding`;
  - raw parameters (`qkv`, `out_proj_kernel`, `gcn_kernel`, `cheb_weight`,
    `cheb_bias`, the SAN FFN's `kernel`/`bias`, MaskedBatchNorm
    `scale`/`bias`, the PNA towers' `kernel`/`bias`, SAN-LSPE's scalar
    `gamma` at the root) keep their flax name and layout;
  - the PNA layers' stacked towers `towers.*` are flax's `nn.vmap` scope
    `towers`, every leaf (batch statistics too) with the tower axis
    first; the PNA GRU's `gru.ir` ... `gru.hn` are flax GRUCell's Dense
    layers; the LSPE nets' `embedding_p`, `p_out` and `Whp` are Dense
    layers like any other;
  - buffers (MaskedBatchNorm `mean`/`var`) come from `batch_stats`;
  - flax's `nn.scan` scope `<scope>/scan_layers/layer` (the JAX FeTA
    encoder built with `scan_layers`) stacks layers 0..S-1 of `<scope>`
    on every leaf's leading axis, batch statistics too: each leaf is
    split into `<scope>/layer_<i>`, so a port model of the same depth
    loads either layout;
  - the GCN modules' `kernel_proj`, `bias`, `h` and `eps`, the ARMA
    filter's `arma_init_weight`, `arma_root_weight` and `arma_bias`, and
    the scalar-coefficient filter's `cheb_weight` keep their flax names.

Every torch tensor must find its leaf and every flax leaf must be used,
or the load raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _flax_scope(module_name: str) -> str:
    parts = module_name.split(".") if module_name else []
    out, i = [], 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts):
            out.append(f"layer_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return "/".join(out)


def _unstack_scans(leaves: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Each `<scope>/scan_layers/layer/<leaf>` [S, ...] split into
    `<scope>/layer_<i>/<leaf>`, i < S."""
    out = {}
    for key, arr in leaves.items():
        scope, stacked, rest = key.partition("/scan_layers/layer/")
        if not stacked:
            out[key] = arr
            continue
        for i in range(arr.shape[0]):
            out[f"{scope}/layer_{i}/{rest}"] = arr[i]
    return out


def from_flax(variables: Mapping, model: nn.Module) -> nn.Module:
    """Copy flax `variables` into `model` in place; returns `model`."""
    leaves = _unstack_scans(
        {f"{coll}/{path}": arr
         for coll in ("params", "batch_stats")
         for path, arr in _flatten(variables.get(coll, {})).items()})
    used = set()
    with torch.no_grad():
        for mod_name, mod in model.named_modules():
            scope = _flax_scope(mod_name)
            own = ([(n, t, "params") for n, t in
                    mod.named_parameters(recurse=False)]
                   + [(n, t, "batch_stats") for n, t in
                      mod.named_buffers(recurse=False)])
            for name, tensor, coll in own:
                leaf, transpose = name, False
                if isinstance(mod, nn.Linear) and name == "weight":
                    leaf, transpose = "kernel", True
                elif isinstance(mod, nn.LayerNorm) and name == "weight":
                    leaf = "scale"
                elif isinstance(mod, nn.Embedding) and name == "weight":
                    leaf = "embedding"
                key = "/".join(p for p in (coll, scope, leaf) if p)
                if key not in leaves:
                    raise KeyError(f"no flax leaf {key!r} for "
                                   f"{mod_name or '<root>'}.{name}")
                arr = leaves[key].T if transpose else leaves[key]
                if tuple(arr.shape) != tuple(tensor.shape):
                    raise ValueError(f"{key}: flax shape {arr.shape} vs "
                                     f"torch {tuple(tensor.shape)}")
                tensor.copy_(torch.from_numpy(np.array(arr, np.float32)))
                used.add(key)
    unused = sorted(set(leaves) - used)
    if unused:
        raise KeyError(f"flax leaves without a torch counterpart: {unused}")
    return model
