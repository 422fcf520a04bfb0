"""GatedGCN with LSPE.

Twin of the JAX package's `nn/gatedgcn.py` (the rebuild of the LSPE
reference's gatedgcn_lspe_layer.py and gatedgcn_net.py). Per layer, for an
edge j -> i with edge features e_ij:

  hat_eta_ij = B1 h_j + B2 h_i + B3 e_ij
  eta_ij     = sigmoid(hat_eta_ij) / (sum_j' sigmoid(hat_eta_ij') + 1e-6)
  h_i'       = A1 [h_i, p_i] + sum_j eta_ij * A2 [h_j, p_j]
  p_i'       = C1 p_i + sum_j eta_ij * C2 p_j
  e_ij'      = hat_eta_ij

then the graph-size norm h' / sqrt(n), batch norm of h' and e' (over real
nodes and real edges), relu / relu / tanh, residuals and dropout.

Two modes, the same parameters and arithmetic on the real edges:

  - dense: the edge features are a [B, N, N, D] field masked to the real
    edges, and the sums over j are masked sums (what the trainers
    collate);
  - sparse: the batch carries its COO edges (`collate_graphs(with_coo=
    True)`; chosen automatically then, or by `sparse_edges`) and the edge
    features are [B, E, D]; gathers and segment sums are one-hot products
    (`ops/sparse_agg.py`).

With `use_lapeig_loss` the net returns (logits, alpha_loss *
`lapeig_loss(p)`), which the trainer adds to the task loss with
`regularization=1.0`, as the JAX trainer does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from feta_tmlr_tpu_torch.data.batch import GraphBatch
from feta_tmlr_tpu_torch.nn.layers import MaskedBatchNorm, dense
from feta_tmlr_tpu_torch.nn.lspe import LSPENetBase, bond_types
from feta_tmlr_tpu_torch.nn.san import embedding, hash_dropout
from feta_tmlr_tpu_torch.ops.masking import (
    in_edge_mask,
    masked_mean,
    pair_mask,
)
from feta_tmlr_tpu_torch.ops.sparse_agg import (
    edge_ids_from_dense,
    make_sparse_edges,
)


class GatedGCNLSPELayer(nn.Module):
    """One GatedGCN-LSPE layer. forward(h, p, e, adj, node_mask, snorm_n,
    edges=None) returns (h, p, e): dense mode with edges None (e [B, N, N,
    D]), sparse mode with a `SparseEdges` (e [B, E, D])."""

    def __init__(self, in_dim: int, output_dim: int, dropout: float = 0.0,
                 batch_norm: bool = True, residual: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        d = output_dim
        self.output_dim, self.dropout = output_dim, dropout
        self.batch_norm = batch_norm
        self.residual = residual and in_dim == output_dim
        self.dropout_generator = dropout_generator or torch.Generator()
        self.A1, self.A2 = dense(2 * in_dim, d, g), dense(2 * in_dim, d, g)
        self.B1, self.B2, self.B3 = (dense(in_dim, d, g), dense(in_dim, d, g),
                                     dense(in_dim, d, g))
        self.C1, self.C2 = dense(in_dim, d, g), dense(in_dim, d, g)
        if batch_norm:
            self.bn_node_h = MaskedBatchNorm(d)
            self.bn_node_e = MaskedBatchNorm(d)

    def forward(self, h, p, e, adj, node_mask, snorm_n, edges=None):
        b, n, _ = h.shape
        hp = torch.cat([h, p], -1)
        a1, a2 = self.A1(hp), self.A2(hp)
        b1, b2, b3 = self.B1(h), self.B2(h), self.B3(e)
        c1, c2 = self.C1(p), self.C2(p)
        d = self.output_dim
        if edges is not None:
            emask = edges.edge_mask
            e_keep = emask.to(h.dtype)[..., None]
            hat_eta = edges.gather_src(b1) + edges.gather_dst(b2) + b3
            sigma = torch.sigmoid(hat_eta) * e_keep
            denom = edges.segment_sum(sigma) + 1e-6
            # pad edges gather a zero denominator row: 0 / 1, not 0 / 0
            ed = edges.gather_dst(denom)
            eta = sigma / torch.where(ed > 0, ed, torch.ones_like(ed))
            agg = edges.segment_sum(torch.cat(
                [eta * edges.gather_src(a2), eta * edges.gather_src(c2)], -1))
            h_new, p_new = a1 + agg[..., :d], c1 + agg[..., d:]
            e_new = hat_eta
        else:
            real = in_edge_mask(adj, node_mask).to(h.dtype)
            # hat_eta[b, i(dst), j(src)] = B1 h_j + B2 h_i + B3 e_ij
            hat_eta = (b1[:, None, :, :] + b2[:, :, None, :]
                       + b3.transpose(1, 2))
            sigma = torch.sigmoid(hat_eta) * real[..., None]
            eta = sigma / (sigma.sum(2, keepdim=True) + 1e-6)
            agg = lambda x2: torch.einsum("bijd,bjd->bid", eta, x2)
            h_new, p_new = a1 + agg(a2), c1 + agg(c2)
            e_new = hat_eta.transpose(1, 2)              # [B, src, dst, D]
            e_keep = real[..., None]
        h_new = h_new * snorm_n[..., None]
        if self.batch_norm:
            h_new = self.bn_node_h(h_new, node_mask)
            if edges is not None:
                e_new = self.bn_node_e(e_new, emask)
            else:
                e_new = self.bn_node_e(
                    e_new.reshape(b, n * n, -1),
                    (real > 0).reshape(b, n * n)).reshape(b, n, n, -1)
        h_new, e_new, p_new = (torch.relu(h_new), torch.relu(e_new),
                               torch.tanh(p_new))
        if self.residual:
            h_new, p_new, e_new = h + h_new, p + p_new, e + e_new
        rate = self.dropout if self.training else 0.0
        drop = lambda t: hash_dropout(t, rate, self.dropout_generator)
        mask_f = node_mask.to(h.dtype)[..., None]
        return drop(h_new) * mask_f, drop(p_new) * mask_f, drop(e_new) * e_keep


def lapeig_loss(p: torch.Tensor, adj: torch.Tensor, node_mask: torch.Tensor,
                pos_enc_dim: int, lambda_loss: float) -> torch.Tensor:
    """The Laplacian-eigenvector loss of gatedgcn_net.py: (trace(p^T L p)
    + lambda * sum_g ||p_g^T p_g - I||_F^2) / (k * B * n) over the batch,
    L the symmetric normalised Laplacian of the real nodes (degree
    clipped at 1). The orthogonality term is computed from detached p, as
    the reference's scipy computation is: it adds no gradient."""
    pm = pair_mask(node_mask).to(p.dtype)
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=p.dtype, device=p.device)
    a = adj * pm * (1.0 - eye)
    dis = a.sum(-1).clamp_min(1.0) ** -0.5
    lap = (node_mask.to(p.dtype)[..., None] * eye
           - dis[..., :, None] * a * dis[..., None, :]) * pm
    pm_ = p * node_mask.to(p.dtype)[..., None]
    trace = torch.einsum("bnk,bnm,bmk->", pm_, lap, pm_)
    p_det = pm_.detach()
    ptp = p_det.transpose(1, 2) @ p_det
    frob = ((ptp - torch.eye(pos_enc_dim, dtype=p.dtype,
                             device=p.device)) ** 2).sum()
    n_total = node_mask.sum().clamp_min(1)
    return (trace + lambda_loss * frob) / (pos_enc_dim * p.shape[0] * n_total)


class GatedGCNLSPENet(LSPENetBase):
    """GatedGCN (with the LSPE p channel) for graph regression and
    classification. forward(batch) -> [B, n_out], or (logits, the
    pre-weighted lapeig term) with `use_lapeig_loss`. `pe_init="lap_pe"`
    adds Linear(lap_pe) to h and keeps p zero (the reference's LapPE
    variant). Sparse mode when the batch carries COO edges, unless
    `sparse_edges` says. Without `edge_features` (the TU graphs carry no
    bond types) the edge channel starts at zero, with no bond embedding.
    Weights from a `torch.Generator` seeded with `seed`, on `device`
    (default CUDA)."""

    def __init__(self, num_atom_type: int, num_bond_type: int,
                 hidden_dim: int = 64, out_dim: int = 64, n_layers: int = 16,
                 pos_enc_dim: int = 20, pe_init: str = "rand_walk",
                 dropout: float = 0.0, in_feat_dropout: float = 0.0,
                 batch_norm: bool = True, residual: bool = True,
                 use_lapeig_loss: bool = False, lambda_loss: float = 1.0,
                 alpha_loss: float = 1e-4, readout: str = "mean",
                 n_out: int = 1, sparse_edges: Optional[bool] = None,
                 categorical_input: bool = True, in_feat_dim: int = 0,
                 edge_features: bool = True, seed: int = 0, device=None):
        super().__init__()
        g = self._init_base(
            num_atom_type=num_atom_type, hidden_dim=hidden_dim,
            pos_enc_dim=pos_enc_dim, pe_init=pe_init, readout=readout,
            categorical_input=categorical_input, in_feat_dim=in_feat_dim,
            in_feat_dropout=in_feat_dropout, seed=seed)
        if pe_init == "lap_pe":
            self.embedding_p = dense(pos_enc_dim, hidden_dim, g)
        self.pos_enc_dim, self.sparse_edges = pos_enc_dim, sparse_edges
        self.use_lapeig_loss = use_lapeig_loss
        self.lambda_loss, self.alpha_loss = lambda_loss, alpha_loss
        self.hidden_dim, self.edge_features = hidden_dim, edge_features
        if edge_features:
            self.embedding_e = embedding(num_bond_type, hidden_dim, g)
        self.layers = nn.ModuleList(
            GatedGCNLSPELayer(
                hidden_dim, out_dim if i + 1 == n_layers else hidden_dim,
                dropout=dropout, batch_norm=batch_norm, residual=residual,
                generator=g, dropout_generator=self.dropout_generator)
            for i in range(n_layers))
        self._add_fusion(out_dim, pos_enc_dim, n_out, g, device)

    def forward(self, batch: GraphBatch):
        sparse = (batch.edge_index is not None if self.sparse_edges is None
                  else self.sparse_edges)
        et = bond_types(self, batch) if self.edge_features else None
        h, p = self._input(batch)
        edges = None
        if sparse:
            edges = make_sparse_edges(batch, dtype=h.dtype)
            e = (self.embedding_e(edge_ids_from_dense(et, edges.src,
                                                      edges.dst))
                 if et is not None else
                 h.new_zeros(edges.src.shape + (self.hidden_dim,)))
        else:
            e = (self.embedding_e(et) if et is not None
                 else h.new_zeros(batch.adj.shape + (self.hidden_dim,)))
        if self.pe_init == "lap_pe":
            h = h + self.embedding_p(batch.lap_pe)
        mask_f = batch.node_mask.to(h.dtype)
        snorm_n = mask_f / mask_f.sum(-1, keepdim=True).clamp_min(1).sqrt()
        for layer in self.layers:
            h, p, e = layer(h, p, e, batch.adj, batch.node_mask, snorm_n,
                            edges)
        p_final = None
        if self.pe_init == "rand_walk":
            p = self.p_out(p)
            if self.use_lapeig_loss:
                # centred and l2-normalised per graph
                mean = masked_mean(p, batch.node_mask, dim=1)
                p = (p - mean[:, None, :]) * mask_f[..., None]
                p = p / ((p ** 2).sum(1, keepdim=True) + 1e-6).sqrt()
            p_final = p
            h = self.Whp(torch.cat([h, p], -1))
        out = self._readout(h, batch.node_mask)
        if self.use_lapeig_loss:
            return out, self.alpha_loss * lapeig_loss(
                p_final, batch.adj, batch.node_mask, self.pos_enc_dim,
                self.lambda_loss)
        return out
