"""SAN with LSPE: the SAN counterpart of the GraphiT-LSPE net.

Dense twin of the JAX package's `nn/san_lspe.py` (the rebuild of the LSPE
reference's san_gt_lspe_layer.py and its net): gamma-weighted full-graph
SAN attention (`nn/san.SANAttention`) over concat(h, p), and a positional
attention channel over p alone, without spectral filtering. The net learns
one gamma, a scalar parameter that every layer's attention reads clamped
to [0, 1]; its gradient flows through the clamp. Bond types enter as the
dense [B, N, N, hidden] edge field. See `nn/lspe.py` for the embeddings,
p_out / Whp and the readout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from feta_tmlr_tpu_torch.data.batch import GraphBatch
from feta_tmlr_tpu_torch.nn.layers import dense
from feta_tmlr_tpu_torch.nn.lspe import LSPENetBase, bond_types
from feta_tmlr_tpu_torch.nn.san import (
    NormedLayer,
    SANAttention,
    embedding,
    hash_dropout,
)


class SANGTLSPELayer(NormedLayer):
    """san_gt_lspe_layer: SAN attention of the h channel over concat(h, p),
    dropout, O_h, residual, norm, FFN, residual, norm; SAN attention of
    the p channel, dropout, O_p, tanh, residual. forward returns (h, p)."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 edge_dim: int, gamma: float = 1e-5,
                 full_graph: bool = True, dropout: float = 0.0,
                 layer_norm: bool = False, batch_norm: bool = True,
                 residual: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        dh = out_dim // num_heads
        self.in_dim, self.out_dim = in_dim, out_dim
        self.dropout, self.residual = dropout, residual
        self.dropout_generator = dropout_generator or torch.Generator()
        self.attention_h = SANAttention(2 * in_dim, dh, num_heads, gamma,
                                        edge_dim, full_graph, generator=g)
        self.O_h = dense(num_heads * dh, out_dim, g)
        self._set_norm(layer_norm, batch_norm)
        self._add_norm("norm1", out_dim)
        self.ffn1 = dense(out_dim, 2 * out_dim, g)
        self.ffn2 = dense(2 * out_dim, out_dim, g)
        self._add_norm("norm2", out_dim)
        self.attention_p = SANAttention(in_dim, dh, num_heads, gamma,
                                        edge_dim, full_graph, generator=g)
        self.O_p = dense(num_heads * dh, out_dim, g)

    def forward(self, h, p, adj, node_mask, e_emb, gamma_value=None):
        rate = self.dropout if self.training else 0.0
        drop = lambda t: hash_dropout(t, rate, self.dropout_generator)
        h_attn, _, _ = self.attention_h(torch.cat([h, p], -1), adj,
                                        node_mask, e_emb=e_emb,
                                        gamma_value=gamma_value)
        x = self.O_h(drop(h_attn))
        if self.residual and self.in_dim == self.out_dim:
            x = h + x
        x = self._normed("norm1", x, node_mask)
        ff = self.ffn2(drop(torch.relu(self.ffn1(x))))
        x = self._normed("norm2", x + ff if self.residual else ff, node_mask)
        p_attn, _, _ = self.attention_p(p, adj, node_mask, e_emb=e_emb,
                                        gamma_value=gamma_value)
        q = torch.tanh(self.O_p(drop(p_attn)))
        if self.residual and self.in_dim == self.out_dim:
            q = p + q
        mask_f = node_mask.to(x.dtype)[..., None]
        return x * mask_f, q * mask_f


class SANLSPENet(LSPENetBase):
    """The SAN-LSPE net: forward(batch) -> [B, n_out]. `gamma` is the
    initial value of the learned gamma. Weights from a `torch.Generator`
    seeded with `seed`, on `device` (default CUDA)."""

    def __init__(self, num_atom_type: int, num_bond_type: int,
                 hidden_dim: int = 64, out_dim: int = 64, n_heads: int = 8,
                 n_layers: int = 6, pos_enc_dim: int = 20,
                 pe_init: str = "rand_walk", gamma: float = 1e-5,
                 full_graph: bool = True, dropout: float = 0.0,
                 in_feat_dropout: float = 0.0, layer_norm: bool = False,
                 batch_norm: bool = True, residual: bool = True,
                 readout: str = "mean", n_out: int = 1,
                 categorical_input: bool = True, in_feat_dim: int = 0,
                 seed: int = 0, device=None):
        super().__init__()
        g = self._init_base(
            num_atom_type=num_atom_type, hidden_dim=hidden_dim,
            pos_enc_dim=pos_enc_dim, pe_init=pe_init, readout=readout,
            categorical_input=categorical_input, in_feat_dim=in_feat_dim,
            in_feat_dropout=in_feat_dropout, seed=seed)
        self.embedding_e = embedding(num_bond_type, hidden_dim, g)
        self.gamma = nn.Parameter(torch.tensor(float(gamma)))
        self.layers = nn.ModuleList(
            SANGTLSPELayer(
                hidden_dim, out_dim if i + 1 == n_layers else hidden_dim,
                n_heads, hidden_dim, gamma=gamma, full_graph=full_graph,
                dropout=dropout, layer_norm=layer_norm,
                batch_norm=batch_norm, residual=residual, generator=g,
                dropout_generator=self.dropout_generator)
            for i in range(n_layers))
        self._add_fusion(out_dim, pos_enc_dim, n_out, g, device)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        e_emb = self.embedding_e(bond_types(self, batch))
        h, p = self._input(batch)
        gamma = self.gamma.clamp(0.0, 1.0)
        for layer in self.layers:
            h, p = layer(h, p, batch.adj, batch.node_mask, e_emb, gamma)
        h, _ = self._fuse(h, p)
        return self._readout(h, batch.node_mask)
