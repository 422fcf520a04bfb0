"""The SAN / LPE tier: gamma-weighted attention nets with a learned
Laplacian eigen-PE (SANNet) and with a static-weight Chebyshev filter in
their layers (SANNodeSpectra).

Dense twin of the JAX package's `nn/san.py` (itself the dense rebuild of
the LPE reference's GraphTransformerLayerSpectra, SAN, SAN_NodeLPE,
SAN_EdgeLPE and SAN_NodeSpectra):

  - per-pair score = sum_d q_i k_j e_ij / sqrt(dh), exp-clamped to [-5, 5];
    on the full graph real edges are weighted 1/(gamma+1) and the other
    pairs of the complete graph (no self loops) gamma/(gamma+1) through a
    second set of projections; on the sparse graph (`full_graph=False`)
    only the real edges are weighted, with no second set; out = wV / (z +
    1e-6);
  - bond types that index a small table take one matmul per type
    (`typed_edge_scores`); otherwise (more than 16 types, or a learned edge
    eigen-PE concatenated to the bond embedding) the edge modulation runs
    over a dense [B, N, N, H*dh] field (`field_scores`);
  - coefficient head: attention row sums -> Linear -> tanh -> masked mean
    -> Linear, scalars per (graph, head) for the static Chebyshev weights
    over the structure Laplacian of the attention graph (the complete
    graph, or the real edges on the sparse graph);
  - the eigen-PE heads run a small transformer over the frequency axis
    whose FFN keeps torch's dim_feedforward=2048 and runs through the
    fused-MLP kernels (`ops/kernels/fused_mlp.py`): per node
    (`LPETransformer`, B*N*m rows) or per node pair (`EdgeLPETransformer`,
    B*N*N*m rows).

Parameters keep the flax names and layouts (`convert.from_flax` copies them
one to one); `Linear` weights are the transposed flax kernels, `ff1_i` and
`ff2_i` raw [in, out] `kernel`/`bias` leaves. Modules take an explicit
`generator` for init. Dropout masks (the layers', the input's and the
eigen-PE head's) come from the fused-MLP kernels' hash of (seed, row,
unit), with one seed drawn per use from the model's CPU `dropout_generator`
(no host sync; the trainer reseeds it from its seed), so a seed gives the
same masks on the CPU and on the card. The JAX nets draw theirs from flax's
RNG, so the two agree at rate 0 and in eval mode.

Torch needs parameter shapes at construction where flax reads them from
the first batch: the nets always build the bond-type embedding (every
dataset of the tier carries bond types; a batch without them raises), and
a float-input net (`categorical_input=False`) takes its feature width as
`in_feat_dim`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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
from feta_tmlr_tpu_torch.nn.lookup import OneHotEmbedding
from feta_tmlr_tpu_torch.ops.cheb import cheb_filter_scalar_coeff
from feta_tmlr_tpu_torch.ops.kernels.fused_mlp import dropout_scale, fused_mlp
from feta_tmlr_tpu_torch.ops.masking import (
    in_edge_mask,
    masked_mean,
    pair_mask,
    pair_mask_no_diag,
)


READOUTS = ("mean", "sum", "max")
LPE_KINDS = ("none", "node", "edge")


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


def embedding(num: int, dim: int, g: torch.Generator) -> nn.Embedding:
    """nn.Embedding with N(0, 1/num) weights from an explicit generator,
    its table gradient a one-hot product (`nn/lookup.py`): the same bits
    run to run on the card."""
    emb = OneHotEmbedding(num, dim)
    with torch.no_grad():
        emb.weight.normal_(0.0, 1.0 / math.sqrt(num), generator=g)
    return emb


def graph_readout(h: torch.Tensor, node_mask: torch.Tensor,
                  readout: str) -> torch.Tensor:
    """[B, N, D] -> [B, D]: the masked "sum", "max" or "mean" over real
    nodes."""
    mask = node_mask[..., None]
    if readout == "sum":
        return (h * mask.to(h.dtype)).sum(1)
    if readout == "max":
        return torch.where(mask, h, torch.finfo(h.dtype).min).amax(1)
    return masked_mean(h, node_mask, dim=1)


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
    in (dst i, src j) layout. An id outside [0, T) matches no type and
    scores 0, as in the JAX package."""
    s = q.new_zeros(q.shape[:-1] + (k.shape[-2],))
    for t in range(table_hd.shape[0]):
        st = q @ (k * table_hd[t][None, :, None, :]).transpose(-1, -2)
        s = torch.where((edge_ids == t)[:, None], st * scale, s)
    return s


def field_scores(q: torch.Tensor, k: torch.Tensor, e: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """score[b,h,i,j] = sum_d q[b,h,i,d] k[b,h,j,d] e[b,i,j,h*dh+d] *
    scale over a dense projected edge field e [B, N(dst), N(src), H*dh]."""
    b, hh, n, dh = q.shape
    em = e.reshape(b, n, n, hh, dh).permute(0, 3, 1, 2, 4)
    prod = q[:, :, :, None, :] * k[:, :, None, :, :] * em
    return prod.sum(-1) * scale


class SANAttention(nn.Module):
    """Multi-head gamma-weighted attention over the full or the sparse
    graph, with typed edges, a dense edge field or (`edge_dim` 0) no edge
    features. forward returns (h_out [B, N, H*dh], attn [B, H, N, N],
    struct_adj [B, N, N])."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 gamma: float = 1e-5, edge_dim: Optional[int] = None,
                 full_graph: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.out_dim, self.num_heads, self.gamma = out_dim, num_heads, gamma
        self.full_graph = full_graph
        width = num_heads * out_dim
        lin = lambda d_in: dense(d_in, width, g, bias=False)
        self.Q, self.K, self.V = lin(in_dim), lin(in_dim), lin(in_dim)
        edge = lambda: None if edge_dim == 0 else lin(edge_dim or in_dim)
        self.E = edge()
        if full_graph:
            self.Q_2, self.K_2 = lin(in_dim), lin(in_dim)
            self.E_2 = edge()

    def forward(self, h, adj, node_mask, e_table=None, edge_ids=None,
                e_emb=None, gamma_value=None):
        """h [B, N, in_dim]; adj [B, N, N] real edges (src, dst); either
        e_table [T, edge_dim] the bond-type embeddings and edge_ids [B, N,
        N] int types (src, dst), or e_emb [B, N, N, edge_dim] the dense
        edge field (src, dst); neither with `edge_dim` 0 (no edge
        features: the scores are q·k alone). gamma_value: a tensor in place
        of the static `gamma` (SAN-LSPE learns one, `nn/san_lspe.py`)."""
        b, n, _ = h.shape
        hh, dh = self.num_heads, self.out_dim
        split = lambda t: t.reshape(b, n, hh, dh).transpose(1, 2)
        real = in_edge_mask(adj, node_mask)
        scale = 1.0 / math.sqrt(dh)
        if self.E is None:
            scores = lambda q, k, _e: (split(q(h)) @ split(k(h)).transpose(
                -1, -2)) * scale
        elif e_emb is None:
            et = edge_ids.transpose(1, 2)
            scores = lambda q, k, e_lin: typed_edge_scores(
                split(q(h)), split(k(h)),
                e_lin(e_table).reshape(-1, hh, dh), et, scale)
        else:
            scores = lambda q, k, e_lin: field_scores(
                split(q(h)), split(k(h)), e_lin(e_emb).transpose(1, 2),
                scale)
        s_real = scores(self.Q, self.K, self.E)
        zero = torch.zeros_like(s_real)
        if self.full_graph:
            pm = pair_mask_no_diag(node_mask)
            s_fake = scores(self.Q_2, self.K_2, self.E_2)
            g = self.gamma if gamma_value is None else gamma_value
            w_real = torch.exp(s_real.clamp(-5.0, 5.0)) / (g + 1.0)
            w_fake = g * torch.exp(s_fake.clamp(-5.0, 5.0)) / (g + 1.0)
            attn = torch.where(real[:, None], w_real,
                               torch.where(pm[:, None], w_fake, zero))
            struct = pm
        else:
            attn = torch.where(real[:, None],
                               torch.exp(s_real.clamp(-5.0, 5.0)), zero)
            struct = real
        v = split(self.V(h))
        h_out = (attn @ v) / (attn.sum(-1, keepdim=True) + 1e-6)
        h_out = h_out.transpose(1, 2).reshape(b, n, hh * dh)
        return (h_out * node_mask.to(h.dtype)[..., None], attn,
                struct.to(h.dtype))


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


def add_feta_filter(layer: nn.Module, filter_order: int, dh: int,
                    g: torch.Generator) -> None:
    """Give `layer` the FeTA block's parameters under their flax names:
    `coeff_head`, `cheb_weight` [K, dh, dh], `cheb_bias` [dh],
    `filt_linear`."""
    k = filter_order
    layer.coeff_head = SANCoeffHead(k, generator=g)
    layer.cheb_weight = nn.Parameter(glorot_uniform_(
        torch.empty(k, dh, dh), g, k * dh, k * dh))
    layer.cheb_bias = nn.Parameter(torch.zeros(dh))
    layer.filt_linear = dense(dh, dh, g)


def feta_filter(layer: nn.Module, heads, attn, struct, node_mask):
    """The FeTA block of `layer` (see `add_feta_filter`): coefficients from
    the detached attention, the scalar-coefficient Chebyshev filter of the
    heads' outputs [B, H, N, dh] over the structure Laplacian of `struct`,
    tanh, filt_linear. Returns [B, H, N, dh]."""
    coeff = layer.coeff_head(attn, node_mask)
    lhat = san_structure_laplacian(struct, node_mask)
    filt = cheb_filter_scalar_coeff(heads, lhat, coeff, layer.cheb_weight,
                                    layer.cheb_bias)
    return layer.filt_linear(torch.tanh(filt))


class NormedLayer(nn.Module):
    """A layer's post-residual norms under their flax names: layer norm
    (`ln_<name>`, eps 1e-5) with `layer_norm`, else masked batch norm
    (`bn_<name>`) with `batch_norm`, else none."""

    def _set_norm(self, layer_norm: bool, batch_norm: bool) -> None:
        self.norm = "ln" if layer_norm else "bn" if batch_norm else None

    def _add_norm(self, name: str, d: int) -> None:
        if self.norm == "ln":
            self.add_module(f"ln_{name}", nn.LayerNorm(d, eps=1e-5))
        elif self.norm == "bn":
            self.add_module(f"bn_{name}", MaskedBatchNorm(d))

    def _normed(self, name: str, x, node_mask):
        if self.norm == "ln":
            return getattr(self, f"ln_{name}")(x)
        if self.norm == "bn":
            return getattr(self, f"bn_{name}")(x, node_mask)
        return x


class SANSpectraLayer(NormedLayer):
    """Attention, the spectral filter fused into its output (`spectra`),
    dropout, O_h, residual, norm, FFN (ReLU, dropout), residual, norm
    (GraphTransformerLayerSpectra; with spectra=False the plain SAN
    layer). The norm is layer norm (`ln_norm1` / `ln_norm2`, eps 1e-5)
    with `layer_norm`, else masked batch norm (`bn_norm1` / `bn_norm2`)
    with `batch_norm`, else none; the first residual needs in_dim ==
    out_dim."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 gamma: float = 1e-5, filter_order: int = 4,
                 edge_dim: Optional[int] = None, full_graph: bool = True,
                 dropout: float = 0.0, layer_norm: bool = False,
                 batch_norm: bool = True, residual: bool = True,
                 spectra: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        dh = out_dim // num_heads
        self.in_dim, self.out_dim, self.num_heads = in_dim, out_dim, num_heads
        self.dropout, self.residual, self.spectra = dropout, residual, spectra
        self.dropout_generator = dropout_generator or torch.Generator()
        self.attention = SANAttention(in_dim, dh, num_heads, gamma, edge_dim,
                                      full_graph, generator=g)
        if spectra:
            add_feta_filter(self, filter_order, dh, g)
        self.O_h = dense(num_heads * dh, out_dim, g)
        self._set_norm(layer_norm, batch_norm)
        self._add_norm("norm1", out_dim)
        self.ffn1 = dense(out_dim, 2 * out_dim, g)
        self.ffn2 = dense(2 * out_dim, out_dim, g)
        self._add_norm("norm2", out_dim)

    def forward(self, h, adj, node_mask, e_table=None, edge_ids=None,
                e_emb=None):
        b, n, _ = h.shape
        hh = self.num_heads
        h_attn, attn, struct = self.attention(h, adj, node_mask, e_table,
                                              edge_ids, e_emb)
        x = h_attn
        if self.spectra:
            dh = h_attn.shape[-1] // hh
            heads = h_attn.reshape(b, n, hh, dh).transpose(1, 2)
            filt = feta_filter(self, heads, attn, struct, node_mask)
            x = x + filt.transpose(1, 2).reshape(b, n, hh * dh)
        rate = self.dropout if self.training else 0.0
        drop = lambda t: hash_dropout(t, rate, self.dropout_generator)
        x = self.O_h(drop(x))
        if self.residual and self.in_dim == self.out_dim:
            x = h + x
        x = self._normed("norm1", x, node_mask)
        ff = self.ffn2(drop(torch.relu(self.ffn1(x))))
        x = self._normed("norm2", x + ff if self.residual else ff, node_mask)
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


class EdgeLPETransformer(nn.Module):
    """Learned edge eigen-PE of SAN_EdgeLPE: per node pair (i, j) and
    frequency m the token (eigvec_im - eigvec_jm, eigvec_im * eigvec_jm,
    eigval_m), a frequency masked where the difference is NaN, through
    `FreqTransformer` over all B*N*N pairs (B*N*N*M rows of its FFN), zero
    on pairs with a padded node. forward(eigvecs [B, N, M], eigvals [B, M],
    node_mask) -> [B, N, N, lpe_dim]."""

    def __init__(self, lpe_dim: int, lpe_heads: int, lpe_layers: int,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lpe_dim = lpe_dim
        self.freq_transformer = FreqTransformer(
            3, lpe_dim, lpe_heads, lpe_layers, generator=generator,
            dropout_generator=dropout_generator)

    def forward(self, eigvecs, eigvals, node_mask):
        b, n, m = eigvecs.shape
        vi, vj = eigvecs[:, :, None, :], eigvecs[:, None, :, :]
        vals = eigvals[:, None, None, :].expand(b, n, n, m)
        tokens = torch.stack([vi - vj, vi * vj, vals], -1)  # [B, N, N, M, 3]
        freq_mask = ~torch.isnan(tokens[..., 0])
        tokens = torch.nan_to_num(tokens, nan=0.0)
        pos = self.freq_transformer(tokens.reshape(b * n * n, m, 3),
                                    freq_mask.reshape(b * n * n, m))
        pos = pos.reshape(b, n, n, self.lpe_dim)
        return pos * pair_mask(node_mask).to(pos.dtype)[..., None]


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


class SANFamily(nn.Module):
    """What SANNet and SANNodeSpectra share: node embedding (ids, or a
    Linear of float features), bond-type embedding, the eigen-PE head of
    `lpe` ("none", "node": concatenated to the node embedding, "edge":
    concatenated to the bond embedding), input dropout, the layers
    (`spectra[i]` says whether layer i filters), and the readout (per node
    with `node_level`, else masked mean, sum or max and an MLP).

    Without `edge_features` (the TU graphs carry no bond types) there is
    no bond embedding: the attention reads no edge features, and the edge
    eigen-PE alone is the SAN_EdgeLPE edge field.

    forward(batch) returns the bare outputs, [B, n_out] or [B, N, n_out]
    with `node_level`. Parameters come from a `torch.Generator` seeded with
    `seed`; `dropout_generator` (CPU, seeded with `seed` too) draws every
    dropout seed. Built on `device` (default CUDA; raises if CUDA is
    absent and the CPU was not asked for). The eigen-PE head keeps the
    reference's FFN width 2048 and dropout 0.1."""

    def __init__(self, *, num_atom_type: int, num_bond_type: int, lpe: str,
                 hidden_dim: int, out_dim: int, n_heads: int, n_layers: int,
                 lpe_dim: int, lpe_heads: int, lpe_layers: int, gamma: float,
                 full_graph: bool, dropout: float, in_feat_dropout: float,
                 layer_norm: bool, batch_norm: bool, residual: bool,
                 filter_order: int, spectra: Sequence[bool], readout: str,
                 n_out: int, node_level: bool, categorical_input: bool,
                 typed_edges: bool, in_feat_dim: int, edge_features: bool,
                 seed: int, device):
        super().__init__()
        if lpe not in LPE_KINDS:
            raise ValueError(f"lpe {lpe!r} is not one of {LPE_KINDS}")
        if readout not in READOUTS:
            raise ValueError(f"readout {readout!r} is not one of {READOUTS}")
        if not categorical_input and in_feat_dim <= 0:
            raise ValueError("categorical_input=False needs in_feat_dim, the "
                             "width of the float node features")
        dev = resolve_device(device)
        self.lpe, self.readout, self.node_level = lpe, readout, node_level
        self.typed_edges, self.in_feat_dropout = typed_edges, in_feat_dropout
        self.edge_features = edge_features
        g = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)
        h_dim = hidden_dim - lpe_dim if lpe == "node" else hidden_dim
        e_dim = hidden_dim - lpe_dim if lpe == "edge" else hidden_dim
        self.embedding_h = (embedding(num_atom_type, h_dim, g)
                            if categorical_input
                            else dense(in_feat_dim, h_dim, g))
        if edge_features:
            self.embedding_e = embedding(num_bond_type, e_dim, g)
        head = {"node": LPETransformer, "edge": EdgeLPETransformer}.get(lpe)
        if head is not None:
            self.pe_transformer = head(
                lpe_dim, lpe_heads, lpe_layers, generator=g,
                dropout_generator=self.dropout_generator)
        edge_dim = ((hidden_dim if lpe == "edge" else e_dim) if edge_features
                    else (lpe_dim if lpe == "edge" else 0))
        self.layers = nn.ModuleList(
            SANSpectraLayer(hidden_dim,
                            out_dim if i + 1 == n_layers else hidden_dim,
                            n_heads, gamma, filter_order, edge_dim=edge_dim,
                            full_graph=full_graph, dropout=dropout,
                            layer_norm=layer_norm, batch_norm=batch_norm,
                            residual=residual, spectra=spectra[i],
                            generator=g,
                            dropout_generator=self.dropout_generator)
            for i in range(n_layers))
        self.mlp_readout = MLPReadout(out_dim, n_out, generator=g)
        self.to(dev)

    def _edges(self, batch: GraphBatch, h: torch.Tensor) -> dict:
        """The layers' edge inputs, and h with the node eigen-PE."""
        edges = {}
        if self.edge_features:
            if batch.edge_type is None:
                raise ValueError(f"{type(self).__name__} reads bond types: "
                                 "the batch has no edge_type")
            edges = (dict(e_table=self.embedding_e.weight,
                          edge_ids=batch.edge_type) if self.typed_edges
                     else dict(e_emb=self.embedding_e(batch.edge_type)))
        if self.lpe == "node":
            h = torch.cat([h, self.pe_transformer(
                batch.eigvecs, batch.eigvals, batch.node_mask)], -1)
        elif self.lpe == "edge":
            epos = self.pe_transformer(batch.eigvecs, batch.eigvals,
                                       batch.node_mask)
            edges["e_emb"] = (torch.cat([edges["e_emb"], epos], -1)
                              if self.edge_features else epos)
        return h, edges

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        h, edges = self._edges(batch, self.embedding_h(batch.x))
        rate = self.in_feat_dropout if self.training else 0.0
        h = hash_dropout(h, rate, self.dropout_generator)
        for layer in self.layers:
            h = layer(h, batch.adj, batch.node_mask, **edges)
        if self.node_level:
            return self.mlp_readout(h)
        return self.mlp_readout(graph_readout(h, batch.node_mask,
                                              self.readout))


class SANNet(SANFamily):
    """The plain SAN family (SAN, SAN_NodeLPE, SAN_EdgeLPE): gamma-weighted
    attention without spectral filtering, the eigen-PE used nowhere
    (lpe "none"), concatenated to the node embedding ("node") or to the
    bond embedding ("edge"). Bond types take the typed route when there
    are at most 16 and no edge eigen-PE (or as `typed_edges` says), else
    the dense edge field. See `SANFamily` for forward, seed and device."""

    def __init__(self, num_atom_type: int, num_bond_type: int,
                 lpe: str = "none", hidden_dim: int = 64, out_dim: int = 64,
                 n_heads: int = 8, n_layers: int = 6, lpe_dim: int = 8,
                 lpe_heads: int = 2, lpe_layers: int = 2,
                 gamma: float = 1e-5, full_graph: bool = True,
                 dropout: float = 0.0, in_feat_dropout: float = 0.0,
                 layer_norm: bool = False, batch_norm: bool = True,
                 residual: bool = True, readout: str = "mean",
                 n_out: int = 1, node_level: bool = False,
                 categorical_input: bool = True,
                 typed_edges: Optional[bool] = None, in_feat_dim: int = 0,
                 edge_features: bool = True, seed: int = 0, device=None):
        typed = (num_bond_type <= 16 and lpe != "edge"
                 if typed_edges is None else typed_edges)
        if typed and lpe == "edge":
            raise ValueError("the edge eigen-PE needs the dense edge field "
                             "(typed_edges=False)")
        super().__init__(
            num_atom_type=num_atom_type, num_bond_type=num_bond_type,
            lpe=lpe, hidden_dim=hidden_dim, out_dim=out_dim, n_heads=n_heads,
            n_layers=n_layers, lpe_dim=lpe_dim, lpe_heads=lpe_heads,
            lpe_layers=lpe_layers, gamma=gamma, full_graph=full_graph,
            dropout=dropout, in_feat_dropout=in_feat_dropout,
            layer_norm=layer_norm, batch_norm=batch_norm, residual=residual,
            filter_order=4, spectra=[False] * n_layers, readout=readout,
            n_out=n_out, node_level=node_level,
            categorical_input=categorical_input, typed_edges=typed,
            in_feat_dim=in_feat_dim, edge_features=edge_features, seed=seed,
            device=device)


class SANNodeSpectra(SANFamily):
    """SAN_NodeSpectra: node embedding concatenated with the learned node
    eigen-PE, SAN spectra layers (the Chebyshev filter in every layer, or
    only in the last with `last_layer_filter`), bond types on the typed
    route when there are at most 16 (or as `typed_edges` says). See
    `SANFamily` for forward, seed and device."""

    def __init__(self, num_atom_type: int, num_bond_type: int,
                 hidden_dim: int = 64, out_dim: int = 64, n_heads: int = 8,
                 n_layers: int = 6, lpe_dim: int = 8, lpe_heads: int = 2,
                 lpe_layers: int = 2, gamma: float = 1e-5,
                 full_graph: bool = True, dropout: float = 0.0,
                 in_feat_dropout: float = 0.0, layer_norm: bool = False,
                 batch_norm: bool = True, residual: bool = True,
                 filter_order: int = 4, last_layer_filter: bool = False,
                 readout: str = "mean", n_out: int = 1,
                 node_level: bool = False, categorical_input: bool = True,
                 typed_edges: Optional[bool] = None, in_feat_dim: int = 0,
                 edge_features: bool = True, seed: int = 0, device=None):
        spectra = [i + 1 == n_layers if last_layer_filter else True
                   for i in range(n_layers)]
        super().__init__(
            num_atom_type=num_atom_type, num_bond_type=num_bond_type,
            lpe="node", hidden_dim=hidden_dim, out_dim=out_dim,
            n_heads=n_heads, n_layers=n_layers, lpe_dim=lpe_dim,
            lpe_heads=lpe_heads, lpe_layers=lpe_layers, gamma=gamma,
            full_graph=full_graph, dropout=dropout,
            in_feat_dropout=in_feat_dropout, layer_norm=layer_norm,
            batch_norm=batch_norm, residual=residual,
            filter_order=filter_order, spectra=spectra, readout=readout,
            n_out=n_out, node_level=node_level,
            categorical_input=categorical_input,
            typed_edges=(num_bond_type <= 16 if typed_edges is None
                         else typed_edges),
            in_feat_dim=in_feat_dim, edge_features=edge_features, seed=seed,
            device=device)
