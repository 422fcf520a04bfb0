"""The FeTA block: attention-graph coefficient GCN + dynamic spectral filter.

Per encoder (filtering the last layer only):
  1. run the GraphiT layers; the last one keeps its per-head outputs;
  2. treat the detached attention matrix as a weighted directed graph and
     run a small GCN over it for per-(graph, head) Chebyshev coefficients;
  3. filter the per-head outputs with a dynamic Chebyshev filter over the
     graph's own scaled Laplacian;
  4. fuse by concatenating with the encoder output and a linear map.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from feta_tmlr_tpu_torch.nn.layers import (
    AttnColStats,
    GraphiTEncoderLayer,
    dense,
    glorot_uniform_,
)
from feta_tmlr_tpu_torch.ops.cheb import cheb_filter_dynamic
from feta_tmlr_tpu_torch.ops.laplacian import (
    cheb_scaled_laplacian,
    gcn_norm_directed,
)
from feta_tmlr_tpu_torch.ops.masking import masked_mean


class FilterCoefficientHead(nn.Module):
    """Coefficient GCN over the detached attention graph: node features
    ones(C), one GCNConv(C, C) + tanh, mean pool per graph, Linear(C, C).

    GCN(ones) collapses to (column sums of the gcn-normalised attention)
    outer (column sums of W), so only s[b, h, j] is needed; the filtered
    layer's kernels deliver s directly (`precomputed_s`)."""

    def __init__(self, num_coefficients: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        c = num_coefficients
        self.gcn_kernel = nn.Parameter(
            glorot_uniform_(torch.empty(c, c), g, c, c))
        self.gcn_bias = nn.Parameter(torch.zeros(c))
        self.coeff_linear = dense(c, c, g)

    def forward(self, attn, node_mask, precomputed_s=None):
        mask_h = node_mask[:, None, :]
        if precomputed_s is not None:
            s = precomputed_s                             # [B, H, N(dst)]
        else:
            # attn[i, j] weighs directed edge i -> j; aggregate at dst
            s = gcn_norm_directed(attn.detach(), mask_h).sum(2)
        hid = torch.tanh(s[..., None] * self.gcn_kernel.sum(0) + self.gcn_bias)
        return self.coeff_linear(masked_mean(hid, mask_h, dim=2))  # [B,H,C]


class FeTAEncoder(nn.Module):
    """GraphiT layers with the last one spectrally filtered (Chebyshev,
    dynamic per-(graph, head) weights) and skip-concat fusion.

    Returns (out [B,N,D], attn of the last layer, coefficients [B, H, C]).
    `attention_impl` picks the layers' kernel route, `head_fold` and
    `flash_need_heads` refine the "flash" route (`nn/layers.py`).
    """

    def __init__(self, d_model: int, n_heads: int, n_layers: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 batch_norm: bool = False, filter_order: int = 4,
                 generator: Optional[torch.Generator] = None,
                 attention_impl: str = "flash", head_fold: bool = False,
                 flash_need_heads: bool = True):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.d_model, self.n_heads, self.n_layers = d_model, n_heads, n_layers
        self.filter_order = filter_order
        dh = d_model // n_heads
        self.layers = nn.ModuleList(
            GraphiTEncoderLayer(d_model, n_heads, dim_feedforward, dropout,
                                batch_norm, generator=g,
                                attention_impl=attention_impl,
                                head_fold=head_fold,
                                flash_need_heads=flash_need_heads)
            for _ in range(n_layers))
        self.coeff_head = FilterCoefficientHead(
            self.num_coefficients, generator=g)
        self.cheb_bias = nn.Parameter(torch.zeros(dh))
        self.linear_cat = dense(2 * d_model, d_model, g)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def num_coefficients(self) -> int:
        return self.filter_order * self.head_dim * self.head_dim

    def forward(self, x, pe, adj, node_mask, degree=None):
        b, n, d = x.shape
        h, dh = self.n_heads, self.head_dim
        lhat = cheb_scaled_laplacian(adj, node_mask, normalization="sym")
        out = x
        attn = heads = None
        for i, layer in enumerate(self.layers):
            out, attn, heads = layer(out, pe, node_mask, degree,
                                     need_heads=i + 1 == self.n_layers)
        if isinstance(attn, AttnColStats):
            coeff = self.coeff_head(None, node_mask, precomputed_s=attn.s)
        else:                                 # dense [B, H, N, N] attention
            coeff = self.coeff_head(attn, node_mask)
        w = coeff.reshape(b, h, self.filter_order, dh, dh)
        filt = cheb_filter_dynamic(heads.transpose(1, 2), lhat, w,
                                   self.cheb_bias)        # [B, H, N, dh]
        filt = filt.transpose(1, 2).reshape(b, n, d)
        filt = filt * node_mask.to(filt.dtype)[..., None]
        out = self.linear_cat(torch.cat([out, filt], dim=-1))
        return out, attn, coeff
