"""SAN_NodeSpectra: gamma-weighted full-graph attention with a learned
Laplacian eigen-PE and a static-weight Chebyshev filter in every layer.

Dense twin of the JAX package's `nn/san.py` (itself the dense rebuild of
the LPE reference's GraphTransformerLayerSpectra and SAN_NodeSpectra):

  - per-pair score = sum_d q_i k_j e_ij / sqrt(dh), exp-clamped to [-5, 5];
    real edges weighted 1/(gamma+1), the other pairs of the complete graph
    (no self loops) gamma/(gamma+1); out = wV / (z + 1e-6);
  - bond types index a small table, so the edge modulation is one matmul
    per type (`typed_edge_scores`) instead of a [B, N, N, H*dh] field;
  - coefficient head: attention row sums -> Linear -> tanh -> masked mean
    -> Linear, scalars per (graph, head) for the static Chebyshev weights
    over the structure Laplacian of the attention graph;
  - the eigen-PE head (`LPETransformer`) runs a small transformer over the
    frequency axis whose FFN keeps torch's dim_feedforward=2048; that FFN
    runs through the fused-MLP kernels (`ops/kernels/fused_mlp.py`).

Parameters keep the flax names and layouts (`convert.from_flax` copies them
one to one); `Linear` weights are the transposed flax kernels, `ff1_i` and
`ff2_i` raw [in, out] `kernel`/`bias` leaves. Modules take an explicit
`generator` for init. Dropout masks come from the fused-MLP kernels' hash
of (seed, row, unit), with one seed drawn per use from the model's CPU
`dropout_generator` (no host sync; the trainer reseeds it from its seed), so
a seed gives the same masks on the CPU and on the card.

Only the ZINC configuration is ported (full graph, typed bond edges, batch
norm, residuals, the filter in every layer, mean readout, layer dropout 0).
Not ported yet: `SANNet`, `EdgeLPETransformer`, the dense edge-field score
path (`typed_edges=False`), the options above and the node-level,
float-input variant.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from feta_tmlr_tpu_torch.data.batch import GraphBatch
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.nn.layers import (
    MaskedBatchNorm,
    dense,
    glorot_uniform_,
    lecun_normal_,
)
from feta_tmlr_tpu_torch.ops.cheb import cheb_filter_scalar_coeff
from feta_tmlr_tpu_torch.ops.kernels.fused_mlp import dropout_scale, fused_mlp
from feta_tmlr_tpu_torch.ops.masking import (
    in_edge_mask,
    masked_mean,
    pair_mask,
    pair_mask_no_diag,
)


def draw_seed(generator: torch.Generator) -> int:
    """A dropout seed in [0, 2^24) from a CPU generator."""
    return int(torch.randint(0, 2 ** 24, (1,), generator=generator))


def hash_dropout(t: torch.Tensor, rate: float,
                 generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout of t over its flattened [rows, last dim] layout,
    with the fused-MLP kernels' mask of a freshly drawn seed."""
    if rate <= 0.0:
        return t
    flat = t.reshape(-1, t.shape[-1])
    scale = dropout_scale(draw_seed(generator), flat.shape[0], flat.shape[1],
                          rate, flat)
    return (flat * scale).reshape(t.shape)


def san_structure_laplacian(struct_adj: torch.Tensor,
                            node_mask: torch.Tensor) -> torch.Tensor:
    """Lhat = 2L/2 - I with L = I - D^{-1/2} A D^{-1/2}, degree clipped at
    1: -D^{-1/2} A D^{-1/2} with a zero diagonal, zero on padding."""
    pm = pair_mask(node_mask).to(struct_adj.dtype)
    n = struct_adj.shape[-1]
    eye = torch.eye(n, dtype=struct_adj.dtype, device=struct_adj.device)
    a = struct_adj * pm * (1.0 - eye)
    dis = a.sum(-1).clamp_min(1.0) ** -0.5
    return -(dis[..., :, None] * a * dis[..., None, :]) * pm


def typed_edge_scores(q: torch.Tensor, k: torch.Tensor,
                      table_hd: torch.Tensor, edge_ids: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """score[b,h,i,j] = sum_d q[b,h,i,d] k[b,h,j,d] table[et[b,i,j],h,d]
    * scale: one matmul per edge type with the type folded into k.

    q, k [B, H, N, dh]; table_hd [T, H, dh]; edge_ids [B, N, N] int types
    in (dst i, src j) layout."""
    s = q.new_zeros(q.shape[:-1] + (k.shape[-2],))
    for t in range(table_hd.shape[0]):
        st = q @ (k * table_hd[t][None, :, None, :]).transpose(-1, -2)
        s = torch.where((edge_ids == t)[:, None], st * scale, s)
    return s


class SANAttention(nn.Module):
    """Multi-head gamma-weighted full-graph attention with typed edges.
    forward returns (h_out [B, N, H*dh], attn [B, H, N, N], struct_adj
    [B, N, N])."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 gamma: float = 1e-5, edge_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.out_dim, self.num_heads, self.gamma = out_dim, num_heads, gamma
        width = num_heads * out_dim
        lin = lambda d_in: dense(d_in, width, g, bias=False)
        self.Q, self.K, self.V = lin(in_dim), lin(in_dim), lin(in_dim)
        self.E = lin(edge_dim or in_dim)
        self.Q_2, self.K_2 = lin(in_dim), lin(in_dim)
        self.E_2 = lin(edge_dim or in_dim)

    def forward(self, h, adj, node_mask, e_table, edge_ids):
        """h [B, N, in_dim]; adj [B, N, N] real edges (src, dst); e_table
        [T, edge_dim] the bond-type embeddings and edge_ids [B, N, N] int
        types (src, dst)."""
        b, n, _ = h.shape
        hh, dh = self.num_heads, self.out_dim
        split = lambda t: t.reshape(b, n, hh, dh).transpose(1, 2)
        pm = pair_mask_no_diag(node_mask)
        real = in_edge_mask(adj, node_mask)
        scale = 1.0 / math.sqrt(dh)
        et = edge_ids.transpose(1, 2)
        scores = lambda q, k, e_lin: typed_edge_scores(
            split(q(h)), split(k(h)), e_lin(e_table).reshape(-1, hh, dh), et,
            scale)
        s_real = scores(self.Q, self.K, self.E)
        s_fake = scores(self.Q_2, self.K_2, self.E_2)
        g = self.gamma
        w_real = torch.exp(s_real.clamp(-5.0, 5.0)) / (g + 1.0)
        w_fake = g * torch.exp(s_fake.clamp(-5.0, 5.0)) / (g + 1.0)
        attn = torch.where(real[:, None], w_real,
                           torch.where(pm[:, None], w_fake,
                                       torch.zeros_like(w_fake)))
        v = split(self.V(h))
        h_out = (attn @ v) / (attn.sum(-1, keepdim=True) + 1e-6)
        h_out = h_out.transpose(1, 2).reshape(b, n, hh * dh)
        return h_out * node_mask.to(h.dtype)[..., None], attn, pm.to(h.dtype)


class SANCoeffHead(nn.Module):
    """Filter coefficients per (graph, head) from the detached attention:
    the GCN over ones(K) features reduces to the row sums broadcast over K,
    then Linear -> tanh -> masked mean over nodes -> Linear."""

    def __init__(self, filter_order: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        k = filter_order
        self.filter_order = k
        self.gcn_linear = dense(k, k, g)
        self.ffn_filter_coeff = dense(k, k, g)

    def forward(self, attn, node_mask):
        rowsum = attn.detach().sum(-1)                        # [B, H, N]
        agg = rowsum[..., None].expand(*rowsum.shape, self.filter_order)
        hgc = torch.tanh(self.gcn_linear(agg))
        pooled = masked_mean(hgc, node_mask[:, None, :], dim=2)
        return self.ffn_filter_coeff(pooled)                  # [B, H, K]


class SANSpectraLayer(nn.Module):
    """Attention, spectral filter fused into its output, O_h, residual,
    batch norm, FFN, residual, batch norm (GraphTransformerLayerSpectra)."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 gamma: float = 1e-5, filter_order: int = 4,
                 edge_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        dh = out_dim // num_heads
        k = filter_order
        self.in_dim, self.out_dim, self.num_heads = in_dim, out_dim, num_heads
        self.attention = SANAttention(in_dim, dh, num_heads, gamma, edge_dim,
                                      generator=g)
        self.coeff_head = SANCoeffHead(k, generator=g)
        self.cheb_weight = nn.Parameter(glorot_uniform_(
            torch.empty(k, dh, dh), g, k * dh, k * dh))
        self.cheb_bias = nn.Parameter(torch.zeros(dh))
        self.filt_linear = dense(dh, dh, g)
        self.O_h = dense(num_heads * dh, out_dim, g)
        self.bn_norm1 = MaskedBatchNorm(out_dim)
        self.ffn1 = dense(out_dim, 2 * out_dim, g)
        self.ffn2 = dense(2 * out_dim, out_dim, g)
        self.bn_norm2 = MaskedBatchNorm(out_dim)

    def forward(self, h, adj, node_mask, e_table, edge_ids):
        b, n, _ = h.shape
        hh = self.num_heads
        h_attn, attn, struct = self.attention(h, adj, node_mask, e_table,
                                              edge_ids)
        dh = h_attn.shape[-1] // hh
        coeff = self.coeff_head(attn, node_mask)
        lhat = san_structure_laplacian(struct, node_mask)
        heads = h_attn.reshape(b, n, hh, dh).transpose(1, 2)
        filt = cheb_filter_scalar_coeff(heads, lhat, coeff, self.cheb_weight,
                                        self.cheb_bias)
        filt = self.filt_linear(torch.tanh(filt))
        x = self.O_h(h_attn + filt.transpose(1, 2).reshape(b, n, hh * dh))
        if self.in_dim == self.out_dim:
            x = h + x
        x = self.bn_norm1(x, node_mask)
        x = self.bn_norm2(x + self.ffn2(torch.relu(self.ffn1(x))), node_mask)
        return x * node_mask.to(x.dtype)[..., None]


class DenseParams(nn.Module):
    """A Dense layer's raw `kernel` [in, out] and `bias` [out], handed to
    the fused-MLP kernels instead of applied."""

    def __init__(self, d_in: int, d_out: int, generator: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(
            lecun_normal_(torch.empty(d_in, d_out), generator, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))


class FreqTransformer(nn.Module):
    """Transformer over the frequency axis of the eigen-PE head: tokens
    [S, M, C_in] -> Linear(C_in, lpe_dim) -> post-norm encoder layers
    (torch.nn.TransformerEncoderLayer semantics, frequency-masked softmax,
    FFN of width ff_dim through `fused_mlp`) -> masked sum over M."""

    def __init__(self, in_dim: int, lpe_dim: int, lpe_heads: int,
                 lpe_layers: int, ff_dim: int = 2048, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        d = lpe_dim
        self.lpe_heads, self.lpe_layers = lpe_heads, lpe_layers
        self.dropout = dropout
        self.dropout_generator = dropout_generator or torch.Generator()
        self.linear_A = dense(in_dim, d, g)
        for i in range(lpe_layers):
            self.add_module(f"qkv_{i}", dense(d, 3 * d, g))
            self.add_module(f"proj_{i}", dense(d, d, g))
            self.add_module(f"n1_{i}", nn.LayerNorm(d, eps=1e-5))
            self.add_module(f"ff1_{i}", DenseParams(d, ff_dim, g))
            self.add_module(f"ff2_{i}", DenseParams(ff_dim, d, g))
            self.add_module(f"n2_{i}", nn.LayerNorm(d, eps=1e-5))

    def forward(self, tokens, freq_mask):
        x = self.linear_A(tokens)
        for i in range(self.lpe_layers):
            x = self._encoder_layer(x, freq_mask, i)
        return torch.where(freq_mask[..., None], x,
                           torch.zeros_like(x)).sum(1)

    def _encoder_layer(self, x, mask, i):
        s, m, d = x.shape
        hn = self.lpe_heads
        dh = d // hn
        layer = lambda name: getattr(self, f"{name}_{i}")
        q, k, v = (t.reshape(s, m, hn, dh).transpose(1, 2)
                   for t in layer("qkv")(x).chunk(3, -1))
        sc = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
        sc = sc.masked_fill(~mask[:, None, None, :], -1e30)
        p = torch.softmax(sc, -1)
        p = p.masked_fill(~mask[:, None, :, None], 0.0)
        out = (p @ v).transpose(1, 2).reshape(s, m, d)
        rate = self.dropout if self.training else 0.0
        drop = lambda t: hash_dropout(t, rate, self.dropout_generator)
        x = layer("n1")(x + drop(layer("proj")(out)))
        ff1, ff2 = layer("ff1"), layer("ff2")
        seed = draw_seed(self.dropout_generator) if rate > 0.0 else None
        ff = fused_mlp(x.reshape(s * m, d), ff1.kernel, ff1.bias, ff2.kernel,
                       ff2.bias, dropout_rate=rate, seed=seed)
        return layer("n2")(x + drop(ff.reshape(s, m, d)))


class LPETransformer(nn.Module):
    """Learned node eigen-PE: tokens (eigvec_im, eigval_m) per frequency
    through `FreqTransformer`, zero on padded nodes. forward(eigvecs
    [B, N, M], eigvals [B, M], node_mask) -> [B, N, lpe_dim]."""

    def __init__(self, lpe_dim: int, lpe_heads: int, lpe_layers: int,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lpe_dim = lpe_dim
        self.freq_transformer = FreqTransformer(
            2, lpe_dim, lpe_heads, lpe_layers, generator=generator,
            dropout_generator=dropout_generator)

    def forward(self, eigvecs, eigvals, node_mask):
        b, n, m = eigvecs.shape
        vals = eigvals[:, None, :].expand(b, n, m)
        tokens = torch.stack([eigvecs, vals], -1)          # [B, N, M, 2]
        freq_mask = ~torch.isnan(tokens[..., 0])
        tokens = torch.nan_to_num(tokens, nan=0.0)
        pos = self.freq_transformer(tokens.reshape(b * n, m, 2),
                                    freq_mask.reshape(b * n, m))
        pos = pos.reshape(b, n, self.lpe_dim)
        return pos * node_mask.to(pos.dtype)[..., None]


class MLPReadout(nn.Module):
    """Halving MLP readout: two Linear + ReLU layers, then Linear."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.fc_0 = dense(in_dim, max(in_dim // 2, 1), g)
        self.fc_1 = dense(max(in_dim // 2, 1), max(in_dim // 4, 1), g)
        self.fc_out = dense(max(in_dim // 4, 1), out_dim, g)

    def forward(self, x):
        return self.fc_out(torch.relu(self.fc_1(torch.relu(self.fc_0(x)))))


class SANNodeSpectra(nn.Module):
    """SAN_NodeSpectra graph regressor (ZINC): atom-id embedding
    concatenated with the learned eigen-PE, SAN spectra layers with typed
    bond edges, masked mean readout, MLP readout.

    forward(batch) returns the bare outputs [B, n_out] and takes no
    regularization argument. Parameters come from a `torch.Generator`
    seeded with `seed`; `dropout_generator` (CPU, seeded with `seed` too)
    draws the eigen-PE head's dropout seeds. Built on `device` (default
    CUDA; raises if CUDA is absent and the CPU was not asked for). The
    eigen-PE head keeps the reference's FFN width 2048 and dropout 0.1."""

    def __init__(self, num_atom_type: int, num_bond_type: int,
                 hidden_dim: int = 64, out_dim: int = 64, n_heads: int = 8,
                 n_layers: int = 6, lpe_dim: int = 8, lpe_heads: int = 2,
                 lpe_layers: int = 2, gamma: float = 1e-5,
                 filter_order: int = 4, n_out: int = 1,
                 seed: int = 0, device=None):
        super().__init__()
        if num_bond_type > 16:
            raise NotImplementedError(
                "only the typed-edge score path (<= 16 bond types) is ported")
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)
        self.embedding_h = self._embedding(num_atom_type,
                                           hidden_dim - lpe_dim, g)
        self.embedding_e = self._embedding(num_bond_type, hidden_dim, g)
        self.pe_transformer = LPETransformer(
            lpe_dim, lpe_heads, lpe_layers, generator=g,
            dropout_generator=self.dropout_generator)
        self.layers = nn.ModuleList(
            SANSpectraLayer(hidden_dim,
                            out_dim if i + 1 == n_layers else hidden_dim,
                            n_heads, gamma, filter_order, edge_dim=hidden_dim,
                            generator=g)
            for i in range(n_layers))
        self.mlp_readout = MLPReadout(out_dim, n_out, generator=g)
        self.to(dev)

    @staticmethod
    def _embedding(num: int, dim: int, g: torch.Generator) -> nn.Embedding:
        emb = nn.Embedding(num, dim)
        with torch.no_grad():
            emb.weight.normal_(0.0, 1.0 / math.sqrt(num), generator=g)
        return emb

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        pos = self.pe_transformer(batch.eigvecs, batch.eigvals,
                                  batch.node_mask)
        h = torch.cat([self.embedding_h(batch.x), pos], -1)
        for layer in self.layers:
            h = layer(h, batch.adj, batch.node_mask, self.embedding_e.weight,
                      batch.edge_type)
        return self.mlp_readout(masked_mean(h, batch.node_mask, dim=1))
