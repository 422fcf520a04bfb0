"""JSON configs of the LPE/LSPE experiment tier.

The files hold {gpu, model, dataset, out_dir, params, net_params} (the
`configs/` corpus); `load_config` reads them with command-line overrides,
`net_params_to_kwargs` maps the reference's net_params names onto the
model constructors' argument names, and `resolve_reference_model_name`
turns (config, --model) into a registry name. The same mapping as the
JAX package's `utils/config.py`; a constructor's accepted names are its
named parameters (`inspect.signature`), where the JAX package reads a
flax dataclass's fields.
"""

from __future__ import annotations

import inspect
import json
from typing import Any, Dict, Optional


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
    """The config dict, with `params` and `net_params` present; each
    non-None override replaces the `params` entry of its name if there is
    one, else sets it in `net_params`."""
    with open(path) as f:
        cfg = json.load(f)
    cfg.setdefault("params", {})
    cfg.setdefault("net_params", {})
    for k, v in (overrides or {}).items():
        if v is None:
            continue
        if k in cfg["params"]:
            cfg["params"][k] = v
        else:
            cfg["net_params"][k] = v
    return cfg


_NET_PARAM_MAP = {
    # reference net_params key -> model kwarg
    "GT_hidden_dim": "hidden_dim",
    "GT_out_dim": "out_dim",
    "GT_n_heads": "n_heads",
    "GT_layers": "n_layers",
    "L": "n_layers",
    "hidden_dim": "hidden_dim",
    "out_dim": "out_dim",
    "n_heads": "n_heads",
    "LPE_dim": "lpe_dim",
    "LPE_n_heads": "lpe_heads",
    "LPE_layers": "lpe_layers",
    "gamma": "gamma",
    "full_graph": "full_graph",
    "dropout": "dropout",
    "in_feat_dropout": "in_feat_dropout",
    "layer_norm": "layer_norm",
    "batch_norm": "batch_norm",
    "residual": "residual",
    "readout": "readout",
    "filter_order": "filter_order",
    "pos_enc_dim": "pos_enc_dim",
    "pe_init": "pe_init",
    "adaptive_edge_PE": "adaptive_edge_pe",
    "use_lapeig_loss": "use_lapeig_loss",
    "lambda_loss": "lambda_loss",
    "alpha_loss": "alpha_loss",
    "init_gamma": "gamma",        # SAN-LSPE learned-gamma init value
    "last_layer_filter": "last_layer_filter",
}


def accepted_kwargs(model_cls) -> set:
    """The named parameters of `model_cls`'s constructor (not `self`, not
    *args / **kwargs: a catch-all would accept any key)."""
    kinds = (inspect.Parameter.POSITIONAL_OR_KEYWORD,
             inspect.Parameter.KEYWORD_ONLY)
    return {name for name, p in
            inspect.signature(model_cls.__init__).parameters.items()
            if name != "self" and p.kind in kinds}


def net_params_to_kwargs(net_params: Dict[str, Any],
                         accepted: Optional[set] = None) -> Dict[str, Any]:
    """Translate a reference net_params dict into model kwargs."""
    out = {}
    for key, val in net_params.items():
        mapped = _NET_PARAM_MAP.get(key)
        if mapped is None:
            continue
        if accepted is not None and mapped not in accepted:
            continue
        out[mapped] = val
    return out


def model_kwargs_for(model_cls, net_params: Dict[str, Any]
                     ) -> Dict[str, Any]:
    accepted = accepted_kwargs(model_cls)
    out = net_params_to_kwargs(net_params, accepted)
    # argument-name aliases across model families (GAT nets use num_heads)
    if "num_heads" in accepted and "n_heads" not in accepted \
            and "n_heads" in net_params:
        out["num_heads"] = net_params["n_heads"]
    return out


LPE_VARIANTS = {
    # the LPE key selects the net variant (LPE load_net convention)
    "node": "SAN_NodeLPE",
    "edge": "SAN_EdgeLPE",
    "none": "SAN",
    "nodespectra": "SAN_NodeSpectra",
    "spectral_node": "SAN_NodeSpectra",
    "gat": "GAT",
    "gat_feta": "GATFeTA",
}


def resolve_reference_model_name(cfg, model_arg=None,
                                 default="SAN_NodeSpectra",
                                 lspe_aliases=None):
    """The registry name of a config's model.

    LPE convention: model 'GraphTransformer' (or legacy 'SAN') plus
    net_params['LPE'] picks the variant. LSPE convention: net_params
    ['pe_init'] marks the tier, and `lspe_aliases` maps its model names
    onto the registry (e.g. {'SAN': 'SAN_LSPE'}). An explicit `model_arg`
    wins over the config's model.
    """
    model_name = model_arg or cfg.get("model") or default
    lpe_kind = cfg.get("net_params", {}).get("LPE")
    if model_name in ("SAN", "GraphTransformer") and lpe_kind:
        return LPE_VARIANTS.get(lpe_kind, model_name)
    if model_name == "GraphTransformer":
        return "SAN"
    if lspe_aliases and cfg.get("net_params", {}).get("pe_init"):
        return lspe_aliases.get(model_name, model_name)
    return model_name
