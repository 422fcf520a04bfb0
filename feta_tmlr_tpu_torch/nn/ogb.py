"""The OGB molecular FeTA models: ogbg-molhiv (binary classifier),
ogbg-molpcba (128-task classifier) and PCQM4M (regressor), the
counterparts of the JAX package's `nn/ogb.py`.

The OGB atom and bond encoders are sums of one embedding per categorical
feature column (ogb.graphproppred.mol_encoder; the vocabularies are
`data/ogb_raw.py`'s ATOM_FEATURE_DIMS and BOND_FEATURE_DIMS). The three
models share one trunk: the atom encoder, the optional Laplacian PE, the
FeTA encoder (its last layer filtered by default), and the masked mean over each
graph's real nodes; then a Linear -> leaky ReLU -> Linear head (`cls_fc1`,
`cls_fc2`). Their CLIs run d_model 128 (molhiv: 8 heads, 4 layers, ff
256), which the unfolded flash kernels take through their wide-row
instantiation (`csrc/strips.cuh`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from feta_tmlr_tpu_torch.data.batch import GraphBatch
from feta_tmlr_tpu_torch.data.ogb_raw import (
    ATOM_FEATURE_DIMS,
    BOND_FEATURE_DIMS,
)
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.nn.feta import FeTAEncoder
from feta_tmlr_tpu_torch.nn.layers import dense
from feta_tmlr_tpu_torch.nn.lookup import Lookup
from feta_tmlr_tpu_torch.nn.models import coefficient_regularizer, embed
from feta_tmlr_tpu_torch.ops.masking import masked_mean


class _EmbeddingSum(nn.Module):
    """The sum of one embedding per integer feature column: x [..., F] ->
    [..., emb_dim]; submodule `<prefix>_<i>` embeds column i.

    Ids index as the JAX package's flax `Embed` (`jnp.take`) does: -V <=
    id < 0 counts from the end of a vocabulary of V rows, and an id outside
    [-V, V) makes its row of the output NaN (an out-of-range index would
    fault the CUDA gather). No host sync checks the ids. The tables'
    gradients are one-hot products (`nn/lookup.py`), the same bits run to
    run."""

    def __init__(self, dims, emb_dim: int, prefix: str,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.dims = tuple(dims)
        self.names = [f"{prefix}_{i}" for i in range(len(dims))]
        for name, vocab in zip(self.names, dims):
            emb = nn.Embedding(vocab, emb_dim)
            with torch.no_grad():
                emb.weight.normal_(0.0, vocab ** -0.5, generator=g)
            self.add_module(name, emb)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.long()
        out, outside = None, None
        for i, (name, vocab) in enumerate(zip(self.names, self.dims)):
            ids = x[..., i]
            bad = (ids < -vocab) | (ids >= vocab)
            e = Lookup.apply(getattr(self, name).weight,
                              torch.where(bad, 0, ids % vocab))
            out = e if out is None else out + e
            outside = bad if outside is None else outside | bad
        return out.masked_fill(outside[..., None], float("nan"))


class OGBAtomEncoder(_EmbeddingSum):
    """x [..., 9] int atom features -> [..., emb_dim]."""

    def __init__(self, emb_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(ATOM_FEATURE_DIMS, emb_dim, "atom_emb", generator)


class OGBBondEncoder(_EmbeddingSum):
    """e [..., 3] int bond features -> [..., emb_dim]."""

    def __init__(self, emb_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(BOND_FEATURE_DIMS, emb_dim, "bond_emb", generator)


class _OGBFeTA(nn.Module):
    """The shared trunk and head. Parameters are drawn from a
    `torch.Generator` seeded with `seed`; the module is built on `device`
    (default CUDA; raises if CUDA is absent and the CPU was not asked for).
    `attention_impl`, `head_fold` and `flash_need_heads` pick the layers'
    kernel route as in `nn/models.py`; `gnn_type`, `last_layer_filter`,
    `learn_only_filter_order_coeff` and `use_skip_conn` are the FeTA
    encoder's filter options (`nn/feta.py`), with the JAX models'
    defaults."""

    def __init__(self, nb_class: int, d_model: int = 128, nb_heads: int = 8,
                 dim_feedforward: int = 256, dropout: float = 0.1,
                 nb_layers: int = 4, batch_norm: bool = False,
                 lap_pos_enc: bool = False, lap_pos_enc_dim: int = 0,
                 filter_order: int = 4, gnn_type: str = "ChebConvDynamic",
                 last_layer_filter: bool = True,
                 learn_only_filter_order_coeff: bool = False,
                 use_skip_conn: bool = True, attention_impl: str = "flash",
                 head_fold: bool = False, flash_need_heads: bool = True,
                 seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.lap_pos_enc = lap_pos_enc
        self.embedding = OGBAtomEncoder(d_model, generator=g)
        if lap_pos_enc:
            self.embedding_lap_pos_enc = dense(lap_pos_enc_dim, d_model, g)
        self.encoder = FeTAEncoder(
            d_model, nb_heads, nb_layers, dim_feedforward, dropout,
            batch_norm, filter_order, gnn_type=gnn_type,
            last_layer_filter=last_layer_filter,
            learn_only_filter_order_coeff=learn_only_filter_order_coeff,
            use_skip_conn=use_skip_conn, generator=g,
            attention_impl=attention_impl, head_fold=head_fold,
            flash_need_heads=flash_need_heads)
        self.cls_fc1 = dense(d_model, d_model, g)
        self.cls_fc2 = dense(d_model, nb_class, g)
        self.to(dev)

    def trunk(self, batch: GraphBatch):
        """(masked mean of the encoder's node features [B, D],
        coefficients)."""
        out, _attn, coeff = self.encoder(embed(self, batch), batch.pe,
                                         batch.adj, batch.node_mask,
                                         degree=batch.degree)
        return masked_mean(out, batch.node_mask, dim=1), coeff

    def head(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.cls_fc2(F.leaky_relu(self.cls_fc1(pooled), 0.01))

    def _outputs(self, batch: GraphBatch, regularization: float):
        """(head output [B, nb_class], the "max" coefficient regularizer)."""
        pooled, coeff = self.trunk(batch)
        out = self.head(pooled)
        reg = (coefficient_regularizer(coeff, "max") if regularization > 0
               else out.new_zeros(()))
        return out, reg


class DiffGraphTransformerGenGCNMolHiv(_OGBFeTA):
    """ogbg-molhiv: forward returns (logits [B], reg, sigmoid(logits))."""

    def forward(self, batch: GraphBatch, regularization: float = 0.0):
        out, reg = self._outputs(batch, regularization)
        logits = out.squeeze(-1)
        return logits, reg, torch.sigmoid(logits)


class DiffGraphTransformerGenGCNMolPcba(_OGBFeTA):
    """ogbg-molpcba: forward returns (logits [B, nb_class], reg)."""

    def forward(self, batch: GraphBatch, regularization: float = 0.0):
        return self._outputs(batch, regularization)


class DiffGraphTransformerGenGCNPCQM4M(_OGBFeTA):
    """PCQM4M (the HOMO-LUMO gap): forward returns (pred [B], reg)."""

    def forward(self, batch: GraphBatch, regularization: float = 0.0):
        out, reg = self._outputs(batch, regularization)
        return out.squeeze(-1), reg
