"""The GraphiT/FeTA model zoo: the FeTA node-level classifier (SBM
PATTERN/CLUSTER) and graph-level model (ZINC, TU), and the GraphiT
baselines the paper compares them with:

  GraphTransformer              layer norm, no PE in the attention
  DiffGraphTransformer          the kernel PE and degrees modulate it
  DiffGraphTransformerGCN       + a GCN over the graph, mean + max pooled
  DiffGraphTransformerSBM       per-node logits
  DiffGraphTransformerMolHiv    OGB atom encoder, sigmoid binary head

Every model draws its parameters from a `torch.Generator` seeded with
`seed` and is built on `device` (default CUDA; raises if CUDA is absent
and the CPU was not asked for). `attention_impl` picks the layers' kernel
route: "flash", "modulation" or "fused"; `head_fold` (and, for the FeTA
models, `flash_need_heads`) refine "flash" (`nn/layers.py`). On the card a
route raises where its kernels do not take the shape (the fused pair and
the folded kernels take D <= 64); no route falls back to another.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from feta_tmlr_tpu_torch.data.batch import GraphBatch
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.nn.feta import FeTAEncoder
from feta_tmlr_tpu_torch.nn.gnn import DenseGCNConv
from feta_tmlr_tpu_torch.nn.layers import GraphiTEncoderLayer, dense
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


def embed(model: nn.Module, batch: GraphBatch) -> torch.Tensor:
    """The input embedding plus, with `lap_pos_enc`, the embedded
    Laplacian PE."""
    x = model.embedding(batch.x)
    if model.lap_pos_enc and batch.lap_pe is not None:
        x = x + model.embedding_lap_pos_enc(batch.lap_pe)
    return x


def masked_max_pool(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """The largest feature over each graph's real nodes: x [B, N, D] ->
    [B, D]."""
    neg = torch.finfo(x.dtype).min
    return torch.where(node_mask.bool()[..., None], x,
                       torch.full_like(x, neg)).amax(1)


class _FeTATransformer(nn.Module):
    """Embedding (+ LapPE) and the FeTA encoder (`nn/feta.py`: its filter
    options `gnn_type`, `last_layer_filter`,
    `learn_only_filter_order_coeff`, `use_skip_conn`, with the JAX models'
    defaults); subclasses add the head. Construction as the module
    docstring says."""

    def __init__(self, in_size: int, nb_class: int, d_model: int,
                 nb_heads: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, nb_layers: int = 4,
                 batch_norm: bool = False, lap_pos_enc: bool = False,
                 lap_pos_enc_dim: int = 0, filter_order: int = 4,
                 gnn_type: str = "ChebConvDynamic",
                 last_layer_filter: bool = True,
                 learn_only_filter_order_coeff: bool = False,
                 use_skip_conn: bool = True,
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
            batch_norm, filter_order, gnn_type=gnn_type,
            last_layer_filter=last_layer_filter,
            learn_only_filter_order_coeff=learn_only_filter_order_coeff,
            use_skip_conn=use_skip_conn, generator=g,
            attention_impl=attention_impl, head_fold=head_fold,
            flash_need_heads=flash_need_heads)
        self.classifier = ClassifierMLP(d_model, nb_class, generator=g)
        self.to(dev)

    def encode(self, batch: GraphBatch):
        """(node features [B, N, D] out of the encoder, coefficients)."""
        out, _attn, coeff = self.encoder(embed(self, batch), batch.pe,
                                         batch.adj, batch.node_mask,
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
    MLP head. Forward returns (logits [B, C], reg). `remat` recomputes
    each encoder layer's forward in the backward."""

    def __init__(self, *args, remat: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.encoder.remat = remat

    def forward(self, batch: GraphBatch, regularization: float = 0.0):
        out, coeff = self.encode(batch)
        pooled = masked_mean(out, batch.node_mask, dim=1)
        return self._with_reg(self.classifier(pooled), coeff, regularization)


class _GraphiT(nn.Module):
    """The GraphiT baselines' trunk: the embedding (+ LapPE) and
    `nb_layers` GraphiT layers with no filter; `modulated` (the kernel PE
    and the degrees in the attention) off for the vanilla transformer.
    Construction as the module docstring says."""

    def __init__(self, d_model: int, nb_heads: int, dim_feedforward: int,
                 dropout: float, nb_layers: int, batch_norm: bool,
                 lap_pos_enc: bool, lap_pos_enc_dim: int, embedding,
                 g: torch.Generator, attention_impl: str, head_fold: bool,
                 modulated: bool = True):
        super().__init__()
        self.lap_pos_enc = lap_pos_enc
        self.modulated = modulated
        self.embedding = embedding
        if lap_pos_enc:
            self.embedding_lap_pos_enc = dense(lap_pos_enc_dim, d_model, g)
        self.layers = nn.ModuleList(
            GraphiTEncoderLayer(d_model, nb_heads, dim_feedforward, dropout,
                                batch_norm, generator=g,
                                attention_impl=attention_impl,
                                head_fold=head_fold)
            for _ in range(nb_layers))

    def encode(self, batch: GraphBatch) -> torch.Tensor:
        """Node features [B, N, D] out of the layers."""
        x = embed(self, batch)
        pe, degree = ((batch.pe, batch.degree) if self.modulated
                      else (None, None))
        for layer in self.layers:
            x, _, _ = layer(x, pe, batch.node_mask, degree, need_heads=False)
        return x


class _GraphiTClassifier(_GraphiT):
    """The trunk with a dense input embedding and the MLP head."""

    def __init__(self, in_size: int, nb_class: int, d_model: int,
                 nb_heads: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, nb_layers: int = 4,
                 batch_norm: bool = False, lap_pos_enc: bool = False,
                 lap_pos_enc_dim: int = 0, attention_impl: str = "flash",
                 head_fold: bool = False, seed: int = 0, device=None,
                 modulated: bool = True):
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        super().__init__(d_model, nb_heads, dim_feedforward, dropout,
                         nb_layers, batch_norm, lap_pos_enc,
                         lap_pos_enc_dim,
                         dense(in_size, d_model, g, bias=False), g,
                         attention_impl, head_fold, modulated)
        self._head(d_model, nb_class, g)
        self.to(dev)

    def _head(self, d_model, nb_class, g):
        self.classifier = ClassifierMLP(d_model, nb_class, generator=g)


class GraphTransformer(_GraphiTClassifier):
    """The vanilla transformer over each graph's nodes: layer norm, the
    Laplacian PE (with `lap_pos_enc`) added to the embedding and nothing
    in the attention, mean pool, MLP head. Forward returns logits
    [B, nb_class]."""

    def __init__(self, in_size: int, nb_class: int, d_model: int,
                 nb_heads: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, nb_layers: int = 4,
                 lap_pos_enc: bool = False, lap_pos_enc_dim: int = 0,
                 attention_impl: str = "flash", head_fold: bool = False,
                 seed: int = 0, device=None):
        super().__init__(in_size, nb_class, d_model, nb_heads,
                         dim_feedforward, dropout, nb_layers, False,
                         lap_pos_enc, lap_pos_enc_dim, attention_impl,
                         head_fold, seed, device, modulated=False)

    def forward(self, batch: GraphBatch):
        return self.classifier(masked_mean(self.encode(batch),
                                           batch.node_mask, dim=1))


class DiffGraphTransformer(_GraphiTClassifier):
    """GraphiT: the kernel PE and the degrees modulate the attention; mean
    pool, MLP head. Forward returns logits [B, nb_class]."""

    def forward(self, batch: GraphBatch):
        return self.classifier(masked_mean(self.encode(batch),
                                           batch.node_mask, dim=1))


class DiffGraphTransformerGCN(_GraphiTClassifier):
    """GraphiT with a GCN over the graph after the last layer: the mean
    pool of the layers' output plus the max pool of ReLU(GCN), MLP head.
    Forward returns logits [B, nb_class]."""

    def _head(self, d_model, nb_class, g):
        self.gcn = DenseGCNConv(d_model, d_model, generator=g)
        super()._head(d_model, nb_class, g)

    def forward(self, batch: GraphBatch):
        x = self.encode(batch)
        gcn = torch.relu(self.gcn(x, batch.adj, batch.node_mask))
        pooled = (masked_mean(x, batch.node_mask, dim=1)
                  + masked_max_pool(gcn, batch.node_mask))
        return self.classifier(pooled)


class DiffGraphTransformerSBM(_GraphiTClassifier):
    """GraphiT node classifier (SBM PATTERN/CLUSTER): per-node logits
    [B, N, nb_class]."""

    def forward(self, batch: GraphBatch):
        return self.classifier(self.encode(batch))


class DiffGraphTransformerMolHiv(_GraphiT):
    """GraphiT on ogbg-molhiv: the OGB atom encoder, mean pool, Linear ->
    leaky ReLU -> Linear head (`cls_fc1`, `cls_fc2`). Forward returns
    (logits [B], 0.0, sigmoid(logits)), the JAX model's triple: the
    Trainer reads the second element as the regularizer."""

    def __init__(self, d_model: int, nb_heads: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 nb_layers: int = 4, batch_norm: bool = False,
                 lap_pos_enc: bool = False, lap_pos_enc_dim: int = 0,
                 attention_impl: str = "flash", head_fold: bool = False,
                 seed: int = 0, device=None):
        from feta_tmlr_tpu_torch.nn.ogb import OGBAtomEncoder
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        super().__init__(d_model, nb_heads, dim_feedforward, dropout,
                         nb_layers, batch_norm, lap_pos_enc,
                         lap_pos_enc_dim, OGBAtomEncoder(d_model, g), g,
                         attention_impl, head_fold)
        self.cls_fc1 = dense(d_model, d_model, g)
        self.cls_fc2 = dense(d_model, 1, g)
        self.to(dev)

    def forward(self, batch: GraphBatch):
        pooled = masked_mean(self.encode(batch), batch.node_mask, dim=1)
        h = F.leaky_relu(self.cls_fc1(pooled), 0.01)
        logits = self.cls_fc2(h).squeeze(-1)
        return logits, 0.0, torch.sigmoid(logits)
