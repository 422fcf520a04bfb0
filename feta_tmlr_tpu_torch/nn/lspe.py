"""The LSPE tier's GraphiT nets: GraphiT-LSPE, with FeTA's spectral
filter (GraphiT_Spectra_LSPE) or without it.

Dense twin of the JAX package's `nn/lspe.py` (itself the dense rebuild of
the LSPE reference's graphit_spectra_lspe_layer.py and graphit_spectra_net
.py): a positional channel p (initialised from the random-walk PE,
`pe/rwpe.py`) runs beside h through every layer, and the h attention reads
concat(h, p).

  - score[b,h,i,j] = sum_d q_i k_j e_ij / sqrt(dh), one set of projections
    on the real edges and a second one (Q_2, K_2, E_2) on the other pairs
    of the complete graph without self loops, exp of the score clamped to
    [-5, 5] on every admissible pair (no gamma weighting, unlike SAN); on
    the sparse graph (`full_graph=False`) the real edges alone; with
    `adaptive_edge_pe` on the full graph the weights are multiplied by the
    p-step random-walk kernel k_RW = (I - gamma L)^p carried in
    `batch.pe`; out = wV / (z + 1e-6);
  - bond types that index a small table take one product per type
    (`typed_edge_scores`, at most 16 types unless `typed_edges` says),
    otherwise the dense [B, N, N, H*dh] edge field (`field_scores`);
  - the h channel: the FeTA block of the SAN tier (`feta_filter`: the
    coefficient head over the detached attention, the scalar-coefficient
    Chebyshev filter over the structure Laplacian, tanh, filt_linear)
    added to the attention output with `spectra`, then dropout, O_h,
    residual, norm, FFN, residual, norm;
  - the p channel: attention over p alone, dropout, O_p, tanh, residual.
    The reference also computes a Chebyshev filter of the p channel and
    then overwrites it (graphit_spectra_lspe_layer.py:578-583); the JAX
    package skips that dead compute, and so does the port: no parameter
    exists for it;
  - the net: embeddings of atoms (or a Linear of float features) and
    bonds, Linear(lap_pe) as p (`pe_init="rand_walk"`; zeros otherwise),
    the layers, then p_out and Whp(concat(h, p)), the per-node readout
    (`node_level`) or a masked mean / sum / max and the MLP readout.
    `use_lapeig_loss` raises NotImplementedError, as in the reference.

Parameters keep the flax names and layouts (`convert.from_flax`). Torch
needs shapes at construction: the nets always build the bond embedding
(every dataset of the tier carries bond types; a batch without them
raises). Dropout masks come from the fused-MLP kernels' hash of a seed
drawn from the model's CPU `dropout_generator` (`nn/san.py`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from feta_tmlr_tpu_torch.config import refuse_bf16
from feta_tmlr_tpu_torch.data.batch import GraphBatch
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.nn.layers import dense
from feta_tmlr_tpu_torch.nn.san import (
    READOUTS,
    MLPReadout,
    NormedLayer,
    add_feta_filter,
    embedding,
    feta_filter,
    field_scores,
    graph_readout,
    hash_dropout,
    typed_edge_scores,
)
from feta_tmlr_tpu_torch.ops.masking import in_edge_mask, pair_mask_no_diag

PE_INITS = ("rand_walk", "lap_pe", "no_pe")


class LSPEAttention(nn.Module):
    """The LSPE tier's multi-head attention (see the module docstring).
    forward returns (out [B, N, H*dh], attn [B, H, N, N], struct_adj
    [B, N, N])."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 edge_dim: int, full_graph: bool = True,
                 adaptive_edge_pe: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.out_dim, self.num_heads = out_dim, num_heads
        self.full_graph, self.adaptive_edge_pe = full_graph, adaptive_edge_pe
        width = num_heads * out_dim
        lin = lambda d_in: dense(d_in, width, g, bias=False)
        self.Q, self.K, self.V = lin(in_dim), lin(in_dim), lin(in_dim)
        edge = lambda: lin(edge_dim) if edge_dim else None
        self.E = edge()
        if full_graph:
            self.Q_2, self.K_2, self.E_2 = lin(in_dim), lin(in_dim), edge()

    def forward(self, x, adj, node_mask, k_rw=None, e_table=None,
                edge_ids=None, e_emb=None):
        """x [B, N, in_dim]; adj [B, N, N] real edges (src, dst); k_rw
        [B, N, N] or None; the bond types as in `SANAttention`: e_table
        [T, edge_dim] with edge_ids [B, N, N], or the field e_emb [B, N, N,
        edge_dim]; neither with `edge_dim` 0 (scores q·k alone)."""
        b, n, _ = x.shape
        hh, dh = self.num_heads, self.out_dim
        split = lambda t: t.reshape(b, n, hh, dh).transpose(1, 2)
        scale = 1.0 / math.sqrt(dh)
        if self.E is None:
            scores = lambda q, k, _e: (split(q(x)) @ split(k(x)).transpose(
                -1, -2)) * scale
        elif e_emb is None:
            et = edge_ids.transpose(1, 2)
            scores = lambda q, k, e_lin: typed_edge_scores(
                split(q(x)), split(k(x)),
                e_lin(e_table).reshape(-1, hh, dh), et, scale)
        else:
            scores = lambda q, k, e_lin: field_scores(
                split(q(x)), split(k(x)), e_lin(e_emb).transpose(1, 2),
                scale)
        real = in_edge_mask(adj, node_mask)
        pm = pair_mask_no_diag(node_mask)
        s = scores(self.Q, self.K, self.E)
        if self.full_graph:
            score = torch.where(real[:, None], s,
                                scores(self.Q_2, self.K_2, self.E_2))
            keep, struct = pm, pm
        else:
            score, keep, struct = s, real, real
        attn = torch.where(keep[:, None], torch.exp(score.clamp(-5.0, 5.0)),
                           torch.zeros_like(score))
        if self.adaptive_edge_pe and self.full_graph and k_rw is not None:
            attn = attn * k_rw[:, None]
        v = split(self.V(x))
        out = (attn @ v) / (attn.sum(-1, keepdim=True) + 1e-6)
        out = out.transpose(1, 2).reshape(b, n, hh * dh)
        return (out * node_mask.to(x.dtype)[..., None], attn,
                struct.to(x.dtype))


class GraphiTSpectraLSPELayer(NormedLayer):
    """GraphiT_Spectra_LSPE_Layer (with `spectra=False` the plain
    GraphiT-LSPE layer). forward(h, p, adj, node_mask, k_rw, edges...)
    returns (h, p), both [B, N, out_dim] and zero on padding. The first
    residual of each channel needs in_dim == out_dim."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 edge_dim: int, full_graph: bool = True,
                 dropout: float = 0.0, layer_norm: bool = False,
                 batch_norm: bool = True, residual: bool = True,
                 adaptive_edge_pe: bool = False, filter_order: int = 4,
                 spectra: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        dh = out_dim // num_heads
        self.in_dim, self.out_dim, self.num_heads = in_dim, out_dim, num_heads
        self.dropout, self.residual, self.spectra = dropout, residual, spectra
        self.dropout_generator = dropout_generator or torch.Generator()
        attention = lambda d_in: LSPEAttention(
            d_in, dh, num_heads, edge_dim, full_graph, adaptive_edge_pe,
            generator=g)
        self.attention_h = attention(2 * in_dim)
        if spectra:
            add_feta_filter(self, filter_order, dh, g)
        self.O_h = dense(num_heads * dh, out_dim, g)
        self._set_norm(layer_norm, batch_norm)
        self._add_norm("norm1", out_dim)
        self.ffn1 = dense(out_dim, 2 * out_dim, g)
        self.ffn2 = dense(2 * out_dim, out_dim, g)
        self._add_norm("norm2", out_dim)
        self.attention_p = attention(in_dim)
        self.O_p = dense(num_heads * dh, out_dim, g)

    def forward(self, h, p, adj, node_mask, k_rw=None, e_table=None,
                edge_ids=None, e_emb=None):
        b, n, _ = h.shape
        hh = self.num_heads
        edges = dict(e_table=e_table, edge_ids=edge_ids, e_emb=e_emb)
        rate = self.dropout if self.training else 0.0
        drop = lambda t: hash_dropout(t, rate, self.dropout_generator)
        h_attn, attn, struct = self.attention_h(
            torch.cat([h, p], -1), adj, node_mask, k_rw, **edges)
        x = h_attn
        if self.spectra:
            dh = h_attn.shape[-1] // hh
            heads = h_attn.reshape(b, n, hh, dh).transpose(1, 2)
            filt = feta_filter(self, heads, attn, struct, node_mask)
            x = x + filt.transpose(1, 2).reshape(b, n, hh * dh)
        x = self.O_h(drop(x))
        if self.residual and self.in_dim == self.out_dim:
            x = h + x
        x = self._normed("norm1", x, node_mask)
        ff = self.ffn2(drop(torch.relu(self.ffn1(x))))
        x = self._normed("norm2", x + ff if self.residual else ff, node_mask)

        p_attn, _, _ = self.attention_p(p, adj, node_mask, k_rw, **edges)
        q = torch.tanh(self.O_p(drop(p_attn)))
        if self.residual and self.in_dim == self.out_dim:
            q = p + q
        mask_f = node_mask.to(x.dtype)[..., None]
        return x * mask_f, q * mask_f


class LSPENetBase(nn.Module):
    """What the LSPE nets share: the atom embedding `embedding_h` (or a
    Linear of `in_feat_dim` float features), the positional input
    `embedding_p` (a Linear of the pos_enc_dim-wide `lap_pe`) with
    `pe_init="rand_walk"`, the fusion `p_out` / `Whp` after the layers,
    the readout, the seeded generators and the device. Under the bf16
    compute policy (`config.py`) `_init_base` raises (ROADMAP Queue 1
    item 4)."""

    def _init_base(self, *, num_atom_type, hidden_dim, pos_enc_dim,
                   pe_init, readout, categorical_input, in_feat_dim,
                   in_feat_dropout, seed):
        """The shared modules; returns the weights' generator."""
        refuse_bf16(type(self).__name__, "Queue 1 item 4")
        if pe_init not in PE_INITS:
            raise ValueError(f"pe_init {pe_init!r} is not one of {PE_INITS}")
        if readout not in READOUTS:
            raise ValueError(f"readout {readout!r} is not one of {READOUTS}")
        if not categorical_input and in_feat_dim <= 0:
            raise ValueError("categorical_input=False needs in_feat_dim, the "
                             "width of the float node features")
        self.pe_init, self.readout = pe_init, readout
        self.in_feat_dropout = in_feat_dropout
        g = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)
        self.embedding_h = (embedding(num_atom_type, hidden_dim, g)
                            if categorical_input
                            else dense(in_feat_dim, hidden_dim, g))
        if pe_init == "rand_walk":
            self.embedding_p = dense(pos_enc_dim, hidden_dim, g)
        return g

    def _add_fusion(self, out_dim, pos_enc_dim, n_out, g, device):
        """p_out / Whp, the MLP readout, and the move to `device`."""
        if self.pe_init == "rand_walk":
            self.p_out = dense(out_dim, pos_enc_dim, g)
            self.Whp = dense(out_dim + pos_enc_dim, out_dim, g)
        self.mlp_readout = MLPReadout(out_dim, n_out, generator=g)
        self.to(resolve_device(device))

    def _input(self, batch: GraphBatch):
        """(h, p) after the embeddings and the input dropout."""
        h = self.embedding_h(batch.x)
        rate = self.in_feat_dropout if self.training else 0.0
        h = hash_dropout(h, rate, self.dropout_generator)
        p = (self.embedding_p(batch.lap_pe) if self.pe_init == "rand_walk"
             else torch.zeros_like(h))
        return h, p

    def _fuse(self, h, p):
        if self.pe_init == "rand_walk":
            p = self.p_out(p)
            h = self.Whp(torch.cat([h, p], -1))
        return h, p

    def _readout(self, h, node_mask, node_level: bool = False):
        if node_level:
            return self.mlp_readout(h)
        return self.mlp_readout(graph_readout(h, node_mask, self.readout))


def bond_types(net: nn.Module, batch: GraphBatch) -> torch.Tensor:
    if batch.edge_type is None:
        raise ValueError(f"{type(net).__name__} reads bond types: the batch "
                         "has no edge_type")
    return batch.edge_type


class GraphiTSpectraNet(LSPENetBase):
    """GraphiTSpectraNet of the LSPE tier (`spectra=False`: the plain
    GraphiT-LSPE net). forward(batch) returns [B, n_out], or [B, N, n_out]
    with `node_level`. Bond types take the typed route when there are at
    most 16 (or as `typed_edges` says), else the dense edge field.
    `adaptive_edge_pe` reads the p-step kernel from `batch.pe`. Without
    `edge_features` (the TU graphs carry no bond types) there is no bond
    embedding and the attention reads no edge features. Weights
    come from a `torch.Generator` seeded with `seed`; built on `device`
    (default CUDA). `gamma` is kept for the configs (the attention has no
    gamma weighting)."""

    def __init__(self, num_atom_type: int, num_bond_type: int,
                 hidden_dim: int = 64, out_dim: int = 64, n_heads: int = 8,
                 n_layers: int = 6, pos_enc_dim: int = 20,
                 pe_init: str = "rand_walk", gamma: float = 1e-5,
                 full_graph: bool = True, adaptive_edge_pe: bool = False,
                 dropout: float = 0.0, in_feat_dropout: float = 0.0,
                 layer_norm: bool = False, batch_norm: bool = True,
                 residual: bool = True, filter_order: int = 4,
                 use_lapeig_loss: bool = False, readout: str = "mean",
                 n_out: int = 1, spectra: bool = True,
                 node_level: bool = False,
                 typed_edges: Optional[bool] = None,
                 categorical_input: bool = True, in_feat_dim: int = 0,
                 edge_features: bool = True, seed: int = 0, device=None):
        super().__init__()
        g = self._init_base(
            num_atom_type=num_atom_type, hidden_dim=hidden_dim,
            pos_enc_dim=pos_enc_dim, pe_init=pe_init, readout=readout,
            categorical_input=categorical_input, in_feat_dim=in_feat_dim,
            in_feat_dropout=in_feat_dropout, seed=seed)
        self.use_lapeig_loss, self.node_level = use_lapeig_loss, node_level
        self.typed_edges = (num_bond_type <= 16 if typed_edges is None
                            else typed_edges)
        self.edge_features = edge_features
        if edge_features:
            self.embedding_e = embedding(num_bond_type, hidden_dim, g)
        self.layers = nn.ModuleList(
            GraphiTSpectraLSPELayer(
                hidden_dim, out_dim if i + 1 == n_layers else hidden_dim,
                n_heads, hidden_dim if edge_features else 0,
                full_graph=full_graph, dropout=dropout,
                layer_norm=layer_norm, batch_norm=batch_norm,
                residual=residual, adaptive_edge_pe=adaptive_edge_pe,
                filter_order=filter_order, spectra=spectra, generator=g,
                dropout_generator=self.dropout_generator)
            for i in range(n_layers))
        self._add_fusion(out_dim, pos_enc_dim, n_out, g, device)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        if self.use_lapeig_loss:
            raise NotImplementedError(
                "use_lapeig_loss raises in the reference spectra net too "
                "(graphit_spectra_net.py:140-143)")
        edges = {}
        if self.edge_features:
            et = bond_types(self, batch)
            edges = (dict(e_table=self.embedding_e.weight, edge_ids=et)
                     if self.typed_edges
                     else dict(e_emb=self.embedding_e(et)))
        h, p = self._input(batch)
        for layer in self.layers:
            h, p = layer(h, p, batch.adj, batch.node_mask, batch.pe, **edges)
        h, _ = self._fuse(h, p)
        return self._readout(h, batch.node_mask, self.node_level)
