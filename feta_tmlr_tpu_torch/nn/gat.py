"""The GAT tier of the LPE codebase, dense-batched: GATNet and GATFeTANet.

Dense twin of the JAX package's `nn/gat.py` (DGL GATConv semantics over a
padded adjacency):

  - `DenseGATConv`: feat = fc(dropout(h)) per head; score[b,h,i,j] =
    LeakyReLU(el[j] + er[i], 0.2) with el = feat . attn_l (the source
    term) and er = feat . attn_r (the destination term), softmaxed over
    each destination's real in-edges, multiplied by the real mask (a node
    without in-edges gets no attention), attention dropout; out = attn @
    feat per head;
  - `GATFeTALayer`: the FeTA block of the SAN spectra layer on top
    (`san.add_feta_filter` / `san.feta_filter`: coefficient head over the
    detached attention, scalar-coefficient Chebyshev over the structure
    Laplacian of the real edges), added to the heads' outputs, then batch
    norm, ELU and the residual; `GATLayer` the same without the filter;
  - the nets: atom embedding to hidden * heads, n_layers - 1 multi-head
    layers, a last single-head layer to out_dim, masked mean / sum / max
    readout (GATNet also per node) and the halving MLP readout.

The nets have no `last_layer_filter` and no `full_graph`, as in the JAX
package: GATFeTANet filters in every layer, whatever a config says.
Parameters keep the flax names (`gatconv.fc`, `gatconv.attn_l` /
`attn_r` [H, dh], `batchnorm_h`, ...); dropout masks as in `nn/san.py`,
from the model's `dropout_generator`.

The bf16 compute policy (`config.py`, FETA_COMPUTE_DTYPE read each time a
net runs) follows the JAX nets' casts: the fc projection in bf16 (its
product rounded once), el and er and attn @ feat as float32 sums of bf16
operands, the scores, softmax and the attention returned float32; the
FeTA filter's Chebyshev step in bf16 and its filt_linear float32 (the JAX
GATFeTALayer's).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from feta_tmlr_tpu_torch import config
from feta_tmlr_tpu_torch.data.batch import GraphBatch
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.nn.layers import (
    MaskedBatchNorm,
    dense,
    dense_in,
    glorot_uniform_,
)
from feta_tmlr_tpu_torch.nn.san import (
    BF16,
    F32,
    READOUTS,
    MLPReadout,
    add_feta_filter,
    embedding,
    feta_filter,
    graph_readout,
    hash_dropout,
)
from feta_tmlr_tpu_torch.ops.masking import in_edge_mask


class DenseGATConv(nn.Module):
    """DGL-style GATConv over a dense adjacency. forward(h, adj, node_mask)
    returns (out [B, N, H, dh], attn [B, H, N(dst), N(src)])."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.out_dim, self.num_heads = out_dim, num_heads
        self.feat_drop, self.attn_drop = feat_drop, attn_drop
        self.negative_slope = negative_slope
        self.dropout_generator = dropout_generator or torch.Generator()
        self.fc = dense(in_dim, num_heads * out_dim, g, bias=False)
        self.attn_l = nn.Parameter(glorot_uniform_(
            torch.empty(num_heads, out_dim), g, num_heads, out_dim))
        self.attn_r = nn.Parameter(glorot_uniform_(
            torch.empty(num_heads, out_dim), g, num_heads, out_dim))

    def forward(self, h, adj, node_mask, cdt=F32):
        """cdt: the compute dtype (bf16: the module docstring)."""
        b, n, _ = h.shape
        drop = lambda t, rate: hash_dropout(
            t, rate if self.training else 0.0, self.dropout_generator)
        feat = dense_in(self.fc, drop(h, self.feat_drop), cdt).reshape(
            b, n, self.num_heads, self.out_dim)
        # bf16: the products of bf16 values exact, their sums float32
        up = (lambda t: t.to(cdt).float()) if cdt == BF16 else (lambda t: t)
        el = (up(feat) * up(self.attn_l)).sum(-1).permute(0, 2, 1)  # [B,H,N]
        er = (up(feat) * up(self.attn_r)).sum(-1).permute(0, 2, 1)
        scores = F.leaky_relu(el[:, :, None, :] + er[:, :, :, None],
                              self.negative_slope)
        real = in_edge_mask(adj, node_mask)[:, None]         # [dst, src]
        attn = torch.softmax(scores.masked_fill(~real, -1e30), -1)
        attn = drop(attn * real.to(attn.dtype), self.attn_drop)
        out = torch.einsum("bhij,bjhd->bihd", up(attn), up(feat))
        return out, attn


class GATLayer(nn.Module):
    """Multi-head DenseGATConv, heads concatenated, batch norm, ELU, the
    residual where the widths agree (gat_layer.py's GATLayer)."""

    filtered = False

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 dropout: float = 0.0, batch_norm: bool = True,
                 residual: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.residual = residual and in_dim == out_dim * num_heads
        self.gatconv = DenseGATConv(in_dim, out_dim, num_heads, dropout,
                                    dropout, generator=g,
                                    dropout_generator=dropout_generator)
        self.batchnorm_h = (MaskedBatchNorm(out_dim * num_heads)
                            if batch_norm else None)

    def forward(self, h, adj, node_mask, cdt=F32):
        b, n, _ = h.shape
        heads_out, attn = self.gatconv(h, adj, node_mask, cdt)
        x = heads_out.reshape(b, n, -1)
        if self.filtered:
            struct = in_edge_mask(adj, node_mask).to(h.dtype)
            filt = feta_filter(self, heads_out.transpose(1, 2), attn, struct,
                               node_mask, cdt, linear_in_cdt=False)
            x = x + filt.transpose(1, 2).reshape(b, n, -1)
        if self.batchnorm_h is not None:
            x = self.batchnorm_h(x, node_mask)
        x = F.elu(x)
        if self.residual:
            x = h + x
        return x * node_mask.to(x.dtype)[..., None]


class GATFeTALayer(GATLayer):
    """GATLayer with the FeTA filter added to the heads' outputs before
    the batch norm (gat_feta_layer.py's GATFeTALayer)."""

    filtered = True

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 dropout: float = 0.0, batch_norm: bool = True,
                 residual: bool = False, filter_order: int = 4,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        g = generator if generator is not None else torch.Generator()
        super().__init__(in_dim, out_dim, num_heads, dropout, batch_norm,
                         residual, g, dropout_generator)
        add_feta_filter(self, filter_order, out_dim, g)


class GATStack(nn.Module):
    """What GATNet and GATFeTANet share: atom embedding to hidden_dim *
    num_heads, n_layers - 1 multi-head layers, a final single-head layer
    to out_dim, input dropout, readout (per node with `node_level`, else
    masked mean, sum or max and the halving MLP).

    forward(batch) returns [B, n_out], or [B, N, n_out] per node. Weights
    from a `torch.Generator` seeded with `seed`, dropout seeds from
    `dropout_generator` (CPU, seeded with `seed`), built on `device`
    (default CUDA; raises if CUDA is absent and the CPU was not asked
    for). The bf16 compute policy (`config.py`) is read each time the net
    runs (the module docstring)."""

    def __init__(self, *, num_atom_type: int, hidden_dim: int, out_dim: int,
                 num_heads: int, n_layers: int, dropout: float,
                 in_feat_dropout: float, batch_norm: bool, residual: bool,
                 readout: str, n_out: int, node_level: bool,
                 filter_order: Optional[int], seed: int, device):
        super().__init__()
        if readout not in READOUTS:
            raise ValueError(f"readout {readout!r} is not one of {READOUTS}")
        dev = resolve_device(device)
        self.readout, self.node_level = readout, node_level
        self.in_feat_dropout = in_feat_dropout
        g = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)
        width = hidden_dim * num_heads
        self.embedding_h = embedding(num_atom_type, width, g)
        kw = dict(generator=g, dropout_generator=self.dropout_generator)
        if filter_order is None:
            layer = lambda d_out, heads: GATLayer(
                width, d_out, heads, dropout, batch_norm, residual, **kw)
        else:
            layer = lambda d_out, heads: GATFeTALayer(
                width, d_out, heads, dropout, batch_norm, residual,
                filter_order, **kw)
        self.layers = nn.ModuleList(
            [layer(hidden_dim, num_heads) for _ in range(n_layers - 1)]
            + [layer(out_dim, 1)])
        self.mlp_readout = MLPReadout(out_dim, n_out, generator=g)
        self.to(dev)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        rate = self.in_feat_dropout if self.training else 0.0
        h = hash_dropout(self.embedding_h(batch.x), rate,
                         self.dropout_generator)
        cdt = config.default_compute_dtype()
        for layer in self.layers:
            h = layer(h, batch.adj, batch.node_mask, cdt)
        if self.node_level:
            return self.mlp_readout(h)
        return self.mlp_readout(graph_readout(h, batch.node_mask,
                                              self.readout))


class GATNet(GATStack):
    """The plain GAT baseline of the LPE tier (gat_net.py, config LPE
    "gat"). See `GATStack` for forward, seed and device."""

    def __init__(self, num_atom_type: int, hidden_dim: int = 18,
                 out_dim: int = 18, num_heads: int = 8, n_layers: int = 4,
                 dropout: float = 0.0, in_feat_dropout: float = 0.0,
                 batch_norm: bool = True, residual: bool = True,
                 readout: str = "mean", n_out: int = 1,
                 node_level: bool = False, seed: int = 0, device=None):
        super().__init__(
            num_atom_type=num_atom_type, hidden_dim=hidden_dim,
            out_dim=out_dim, num_heads=num_heads, n_layers=n_layers,
            dropout=dropout, in_feat_dropout=in_feat_dropout,
            batch_norm=batch_norm, residual=residual, readout=readout,
            n_out=n_out, node_level=node_level, filter_order=None,
            seed=seed, device=device)


class GATFeTANet(GATStack):
    """gat_feta_net.py: GATNet with the FeTA filter (Chebyshev order
    `filter_order`) in every layer, graph-level only. See `GATStack` for
    forward, seed and device."""

    def __init__(self, num_atom_type: int, hidden_dim: int = 18,
                 out_dim: int = 18, num_heads: int = 8, n_layers: int = 4,
                 dropout: float = 0.0, in_feat_dropout: float = 0.0,
                 batch_norm: bool = True, residual: bool = True,
                 filter_order: int = 4, readout: str = "mean",
                 n_out: int = 1, seed: int = 0, device=None):
        super().__init__(
            num_atom_type=num_atom_type, hidden_dim=hidden_dim,
            out_dim=out_dim, num_heads=num_heads, n_layers=n_layers,
            dropout=dropout, in_feat_dropout=in_feat_dropout,
            batch_norm=batch_norm, residual=residual, readout=readout,
            n_out=n_out, node_level=False, filter_order=filter_order,
            seed=seed, device=device)
