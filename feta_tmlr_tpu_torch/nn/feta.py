"""The FeTA block: attention-graph coefficient GCN + dynamic spectral filter.

Per filtered layer (the last one, or every one without
`last_layer_filter`):
  1. run the GraphiT layer, keeping its per-head outputs;
  2. treat the detached attention matrix as a weighted directed graph and
     run a small GCN over it for per-(graph, head) filter coefficients;
  3. filter the per-head outputs over the graph itself: a dynamic
     Chebyshev filter over its scaled Laplacian (per-(graph, head) weight
     matrices, or scalar gains of one static weight per order with
     `learn_only_filter_order_coeff`), or a dynamic ARMA filter over its
     normalised adjacency (`gnn_type="ARMAConvDynamic"`);
  4. with `use_skip_conn`, sum the filtered signals and fuse them with the
     encoder output by a concatenation and a linear map; without it, the
     filtered signal replaces the layer's output and feeds the next layer.
A `gnn_type` without "Dynamic" in its name filters nothing.

Under the bf16 compute policy (`config.py`, FETA_COMPUTE_DTYPE read each
time the encoder runs) the layers take it and the Chebyshev filter runs in
bf16 (the per-head signals, the scaled Laplacian, the coefficients, the
weights and the bias), back to float32 after it, as the JAX encoder does;
the ARMA filter and the coefficient head stay float32.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from feta_tmlr_tpu_torch import config
from feta_tmlr_tpu_torch.nn.layers import (
    AttnColStats,
    GraphiTEncoderLayer,
    dense,
    glorot_uniform_,
)
from feta_tmlr_tpu_torch.ops.arma import (
    arma_filter_dynamic,
    gcn_norm_no_self_loops,
)
from feta_tmlr_tpu_torch.ops.cheb import (
    cheb_filter_dynamic,
    cheb_filter_scalar_coeff,
)
from feta_tmlr_tpu_torch.ops.lambda_max import laplacian_lambda_max
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


@contextlib.contextmanager
def kept_buffers(module: nn.Module):
    """Restore `module`'s buffers on exit: a recomputed forward (`remat`)
    must not update the batch-norm running statistics a second time."""
    saved = [b.clone() for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(module.buffers(), saved):
                b.copy_(s)


class FeTAEncoder(nn.Module):
    """GraphiT layers, the filtered ones spectrally filtered with dynamic
    per-(graph, head) coefficients (the module docstring's steps).

    Returns (out [B,N,D], attn of the last layer, coefficients
    [B, Lf*H, C] for Lf filtered layers). The coefficient head and the
    filter's parameters are shared by the filtered layers.
    `laplacian_norm` 'rw' or None scales the Chebyshev filter by each
    graph's largest eigenvalue (`ops/lambda_max.py`). `remat` recomputes
    each layer's forward in the backward (`torch.utils.checkpoint`).
    `attention_impl` picks the layers' kernel route, `head_fold` and
    `flash_need_heads` refine the "flash" route (`nn/layers.py`).
    """

    coeff_head_cls = FilterCoefficientHead

    def __init__(self, d_model: int, n_heads: int, n_layers: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 batch_norm: bool = False, filter_order: int = 4,
                 gnn_type: str = "ChebConvDynamic",
                 last_layer_filter: bool = True,
                 learn_only_filter_order_coeff: bool = False,
                 use_skip_conn: bool = True,
                 laplacian_norm: Optional[str] = "sym", remat: bool = False,
                 generator: Optional[torch.Generator] = None,
                 attention_impl: str = "flash", head_fold: bool = False,
                 flash_need_heads: bool = True):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.d_model, self.n_heads, self.n_layers = d_model, n_heads, n_layers
        self.filter_order = filter_order
        self.gnn_type = gnn_type
        self.dynamic = "dynamic" in gnn_type.lower()
        if self.dynamic and gnn_type not in ("ChebConvDynamic",
                                             "ARMAConvDynamic"):
            raise NotImplementedError(
                f"gnn_type {gnn_type} filter not implemented")
        self.last_layer_filter = last_layer_filter
        self.learn_only_filter_order_coeff = learn_only_filter_order_coeff
        self.use_skip_conn = use_skip_conn
        self.laplacian_norm = laplacian_norm
        self.remat = remat
        dh = d_model // n_heads
        k = filter_order
        self.layers = nn.ModuleList(
            GraphiTEncoderLayer(d_model, n_heads, dim_feedforward, dropout,
                                batch_norm, generator=g,
                                attention_impl=attention_impl,
                                head_fold=head_fold,
                                flash_need_heads=flash_need_heads)
            for _ in range(n_layers))
        if not self.dynamic:
            return
        self.coeff_head = self.coeff_head_cls(
            self.num_coefficients, generator=g)
        glorot = lambda: nn.Parameter(glorot_uniform_(
            torch.empty(k, dh, dh), g, k * dh, k * dh))
        if gnn_type == "ARMAConvDynamic":
            self.arma_init_weight = glorot()
            self.arma_root_weight = glorot()
            self.arma_bias = nn.Parameter(torch.zeros(k, 1, dh))
        else:
            if learn_only_filter_order_coeff:
                self.cheb_weight = glorot()
            self.cheb_bias = nn.Parameter(torch.zeros(dh))
        if use_skip_conn:
            self.linear_cat = dense(2 * d_model, d_model, g)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def num_coefficients(self) -> int:
        """Coefficients per (graph, head): K dh^2 (dynamic Chebyshev), K
        (scalar gains, or a filter-less gnn_type), 2K (ARMA)."""
        if self.gnn_type == "ARMAConvDynamic":
            return 2 * self.filter_order
        if (self.gnn_type == "ChebConvDynamic"
                and not self.learn_only_filter_order_coeff):
            return self.filter_order * self.head_dim * self.head_dim
        return self.filter_order

    def filtered(self, i: int) -> bool:
        return self.dynamic and (not self.last_layer_filter
                                 or i + 1 == self.n_layers)

    def _layer(self, layer, x, pe, node_mask, degree, need_heads):
        if not (self.remat and torch.is_grad_enabled()):
            return layer(x, pe, node_mask, degree, need_heads=need_heads)
        return checkpoint(
            layer, x, pe, node_mask, degree, need_heads, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                kept_buffers(layer)))

    def _filter(self, heads, graph, coeff):
        """heads [B, H, N, dh] filtered over `graph` (the scaled Laplacian,
        or ARMA's normalised adjacency) with the coefficients [B, H, C]."""
        b, h, _, dh = heads.shape
        if self.gnn_type == "ARMAConvDynamic":
            return arma_filter_dynamic(
                heads, graph, coeff, self.arma_init_weight,
                self.arma_root_weight, self.arma_bias, activation=torch.relu)
        bf16 = config.default_compute_dtype() == torch.bfloat16
        # the Chebyshev chain in bf16, back to float32 after it
        lo = (lambda t: t.to(torch.bfloat16)) if bf16 else (lambda t: t)
        heads, graph, coeff = lo(heads), lo(graph), lo(coeff)
        if self.learn_only_filter_order_coeff:
            filt = cheb_filter_scalar_coeff(heads, graph, coeff,
                                            lo(self.cheb_weight),
                                            lo(self.cheb_bias))
        else:
            w = coeff.reshape(b, h, self.filter_order, dh, dh)
            filt = cheb_filter_dynamic(heads, graph, w, lo(self.cheb_bias))
        return filt.float() if bf16 else filt

    def forward(self, x, pe, adj, node_mask, degree=None):
        b, n, d = x.shape
        graph = None
        if self.gnn_type == "ChebConvDynamic":
            lam = None
            if self.laplacian_norm != "sym":
                lam = laplacian_lambda_max(adj, node_mask,
                                           normalization=self.laplacian_norm)
            graph = cheb_scaled_laplacian(adj, node_mask,
                                          normalization=self.laplacian_norm,
                                          lambda_max=lam)
        elif self.gnn_type == "ARMAConvDynamic":
            graph = gcn_norm_no_self_loops(adj, node_mask)
        mask_f = node_mask.to(x.dtype)[..., None]
        out = x
        attn = filtered_sum = None
        coeffs = []
        for i, layer in enumerate(self.layers):
            filtered = self.filtered(i)
            out, attn, heads = self._layer(layer, out, pe, node_mask,
                                           degree, filtered)
            if not filtered:
                continue
            if isinstance(attn, AttnColStats):
                coeff = self.coeff_head(None, node_mask,
                                        precomputed_s=attn.s)
            else:                             # dense [B, H, N, N] attention
                coeff = self.coeff_head(attn, node_mask)
            coeffs.append(coeff)
            filt = self._filter(heads.transpose(1, 2), graph, coeff)
            filt = filt.transpose(1, 2).reshape(b, n, d) * mask_f
            if self.use_skip_conn:
                filtered_sum = (filt if filtered_sum is None
                                else filtered_sum + filt)
            else:                   # the filtered signal feeds the next layer
                out = filt
        if filtered_sum is not None:
            out = self.linear_cat(torch.cat([out, filtered_sum], dim=-1))
        coeff = (torch.cat(coeffs, dim=1) if coeffs
                 else x.new_zeros((b, 0, self.num_coefficients)))
        return out, attn, coeff
