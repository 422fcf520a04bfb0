"""FeTA node-level classifier (SBM PATTERN/CLUSTER), FeTA graph-level
model (ZINC), and their pieces."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from feta_tmlr_tpu_torch.data.batch import GraphBatch
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.nn.feta import FeTAEncoder
from feta_tmlr_tpu_torch.nn.layers import dense
from feta_tmlr_tpu_torch.ops.masking import masked_mean


class ClassifierMLP(nn.Module):
    """Linear -> ReLU -> Linear head."""

    def __init__(self, d_model: int, nb_class: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.fc1 = dense(d_model, d_model, g)
        self.fc2 = dense(d_model, nb_class, g)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def coefficient_regularizer(coeff: torch.Tensor,
                            reg_type: str = "pairwise") -> torch.Tensor:
    """'pairwise': mean Frobenius norm of the per-graph [H, C] coefficients
    (what the reference's overwritten cosine-Gram code computes); 'max':
    sum over graphs of the largest off-diagonal cosine similarity between
    heads' coefficient vectors."""
    if coeff.shape[1] == 0:
        return coeff.new_zeros(())
    if reg_type == "pairwise":
        return (coeff ** 2).sum((1, 2)).sqrt().mean()
    if reg_type == "max":
        gm = coeff @ coeff.transpose(1, 2)
        eye = torch.eye(coeff.shape[1], dtype=coeff.dtype,
                        device=coeff.device)
        norms = (coeff ** 2).sum(-1).sqrt()
        denom = norms[:, :, None] * norms[:, None, :]
        cos = gm * (1.0 - eye) / torch.where(denom > 0, denom,
                                             torch.ones_like(denom))
        return cos.amax((1, 2)).sum()
    raise ValueError(f"unknown reg_type {reg_type}")


class _FeTATransformer(nn.Module):
    """Embedding (+ LapPE) and the FeTA encoder, with the last layer
    filtered by a dynamic Chebyshev filter; subclasses add the head.

    Parameters are drawn from a `torch.Generator` seeded with `seed`; the
    module is built on `device` (default CUDA; raises if CUDA is absent and
    the CPU was not asked for). `attention_impl` picks the layers' kernel
    route: "flash", "modulation" or "fused"; `head_fold` and
    `flash_need_heads` refine "flash" (`nn/layers.py`). Only the JAX
    models' default variant is ported: gnn_type 'ChebConvDynamic',
    last_layer_filter, dynamic coefficients and use_skip_conn.
    """

    def __init__(self, in_size: int, nb_class: int, d_model: int,
                 nb_heads: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, nb_layers: int = 4,
                 batch_norm: bool = False, lap_pos_enc: bool = False,
                 lap_pos_enc_dim: int = 0, filter_order: int = 4,
                 attention_impl: str = "flash", head_fold: bool = False,
                 flash_need_heads: bool = True, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.lap_pos_enc = lap_pos_enc
        self.embedding = dense(in_size, d_model, g, bias=False)
        if lap_pos_enc:
            self.embedding_lap_pos_enc = dense(lap_pos_enc_dim, d_model, g)
        self.encoder = FeTAEncoder(
            d_model, nb_heads, nb_layers, dim_feedforward, dropout,
            batch_norm, filter_order, generator=g,
            attention_impl=attention_impl, head_fold=head_fold,
            flash_need_heads=flash_need_heads)
        self.classifier = ClassifierMLP(d_model, nb_class, generator=g)
        self.to(dev)

    def encode(self, batch: GraphBatch):
        """(node features [B, N, D] out of the encoder, coefficients)."""
        x = self.embedding(batch.x)
        if self.lap_pos_enc and batch.lap_pe is not None:
            x = x + self.embedding_lap_pos_enc(batch.lap_pe)
        out, _attn, coeff = self.encoder(x, batch.pe, batch.adj,
                                         batch.node_mask,
                                         degree=batch.degree)
        return out, coeff

    def _with_reg(self, logits, coeff, regularization):
        reg = (coefficient_regularizer(coeff) if regularization > 0
               else logits.new_zeros(()))
        return logits, reg


class DiffGraphTransformerGenGCNSBM(_FeTATransformer):
    """FeTA node classifier (SBM PATTERN/CLUSTER): a per-node MLP head.
    Forward returns (logits [B, N, C], reg)."""

    def forward(self, batch: GraphBatch, regularization: float = 0.0):
        out, coeff = self.encode(batch)
        return self._with_reg(self.classifier(out), coeff, regularization)


class DiffGraphTransformerGenGCN(_FeTATransformer):
    """FeTA graph-level model (ZINC regression, graph classification): the
    masked mean of the node features over each graph's real nodes, then the
    MLP head. Forward returns (logits [B, C], reg)."""

    def forward(self, batch: GraphBatch, regularization: float = 0.0):
        out, coeff = self.encode(batch)
        pooled = masked_mean(out, batch.node_mask, dim=1)
        return self._with_reg(self.classifier(pooled), coeff, regularization)
