"""The GraphiT encoder layer: kernel-modulated attention + FFN block.

Post-attention structure follows torch.nn.TransformerEncoderLayer
(residual -> norm1 -> FFN(relu) -> residual -> norm2), with a masked
batch-norm variant. Attention runs through one of three kernel routes,
chosen by `attention_impl` (the values of the JAX package's
FETA_PALLAS_IMPL, and its dispatch with the Pallas kernels on):

  "flash"       every layer through the online-softmax kernels
                (`ops/kernels/flash_attention.py`); the filtered layer gets
                the coefficient head's column statistics from them;
  "modulation"  every layer computes its scores [B, H, N, N] with a plain
                product and runs the modulation kernel on them
                (`ops/kernels/modulation.py`);
  "fused"       unfiltered layers through the fused attention kernels
                (`ops/kernels/fused_attention.py`, N <= 128); the filtered
                layer as under "modulation".

Two more options refine the "flash" route, as the JAX package's
environment switches refine its flash dispatch (they change nothing under
"modulation" and "fused", as the switches change nothing there):

  head_fold         (FETA_FLASH_HEAD_FOLD=1) every flash call, forward and
                    backward, through the head-folded kernels
                    (`csrc/flash_hf.cu`: one block per graph tile for all
                    heads);
  flash_need_heads  (FETA_FLASH_NEED_HEADS, default on) the filtered layer
                    through the flash kernels and the column statistics;
                    off, it takes the score route with the modulation
                    kernel, a dense [B, H, N, N] attention in device memory.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors.

A `pair_mask` (packed rows, `nn/packed.py`: attention within each packed
graph only) takes every layer onto the score route with the plain
pair-masked chain (`ops/attention.py`) on every device, whatever
`attention_impl` says: no kernel takes a pair mask, and the JAX package
routes packed rows the same way.

The bf16 compute policy (`config.py`, FETA_COMPUTE_DTYPE read each time
the layer runs) follows the JAX layer's casts: the
score, value and output products and the FFN take bf16 operands, each
product's float32 sums rounded once (`ops/cheb.py`'s note); the pe and
degree streams go to the flash kernels in bf16 unless
FETA_BF16_MODULATION=0, as they go to the plain pair-masked chain; the
parameters, cq, ck, c0, the residual stream, the softmax and the norms
stay float32. On the "fused" route xa, x and vw go to the fused kernels in
bf16 with pe and degree float32 (JAX's fused wrapper casts them so), and
its bf16 output plus the float32 output bias is float32; the filtered
layer there takes the score route and the float32 modulation kernel, as
under "modulation". `head_fold` has no bf16 kernels in the port yet and
raises under the policy (ROADMAP Queue 2 item A2).

Parameters keep the JAX package's layout so that `convert.from_flax` copies
them one to one: `qkv` [d, 3d] and `out_proj_kernel` [d, d] are [in, out]
matrices; `nn.Linear` weights are the transposed flax kernels.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from feta_tmlr_tpu_torch import config
from feta_tmlr_tpu_torch.ops.attention import modulated_attention_from_scores
from feta_tmlr_tpu_torch.ops.cheb import head_sum_matmul, matmul, node_matmul
from feta_tmlr_tpu_torch.ops.kernels.flash_attention import (
    flash_graphit_attention,
    flash_graphit_attention_heads,
)
from feta_tmlr_tpu_torch.ops.kernels.fused_attention import (
    fused_graphit_attention,
)
from feta_tmlr_tpu_torch.ops.kernels.modulation import (
    fused_modulated_attention,
)

ATTENTION_IMPLS = ("flash", "modulation", "fused")


class AttnColStats(NamedTuple):
    """Detached coefficient-head statistics emitted by the filtered layer
    in place of a dense attention matrix:
    s[b, h, j] = sum_i gcn_norm_directed(attn)[b, h, i, j]."""

    s: torch.Tensor          # [B, H, N]


def lecun_normal_(t: torch.Tensor, generator: torch.Generator,
                  fan_in: int) -> torch.Tensor:
    """N(0, 1/fan_in) init from an explicit generator."""
    with torch.no_grad():
        return t.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)


def glorot_uniform_(t: torch.Tensor, generator: torch.Generator,
                    fan_in: int, fan_out: int) -> torch.Tensor:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def dense(d_in: int, d_out: int, generator: torch.Generator,
          bias: bool = True) -> nn.Linear:
    """nn.Linear with a lecun-normal weight and zero bias (flax Dense)."""
    lin = nn.Linear(d_in, d_out, bias=bias)
    lecun_normal_(lin.weight, generator, d_in)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def dense_in(lin: nn.Linear, x: torch.Tensor, cdt: torch.dtype):
    """lin(x) as flax's Dense(dtype=cdt): under bf16 x, the weight and the
    bias in bf16, the product rounded once (`ops/cheb.matmul`), the bias
    added in bf16; otherwise lin(x)."""
    if cdt != torch.bfloat16:
        return lin(x)
    y = matmul(x.to(cdt), lin.weight.t().to(cdt))
    return y if lin.bias is None else y + lin.bias.to(cdt)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over features with statistics over real nodes only.

    Eval uses the running statistics (buffers `mean`, `var`); training
    uses the masked batch statistics and updates the running ones as
    `running = momentum * running + (1 - momentum) * batch` (flax's
    convention: momentum 0.9 here is torch's 0.1).

    x is [..., B, N, d] and node_mask [B, N]; with `lead` (the PNA towers'
    (T,)) the parameters and statistics are stacked [*lead, d], one set
    for each leading index of x [*lead, B, N, d], as flax's `nn.vmap`
    stacks them."""

    def __init__(self, d: int, lead: tuple = ()):
        super().__init__()
        self.momentum = 0.9
        self.eps = 1e-5
        self.scale = nn.Parameter(torch.ones(*lead, d))
        self.bias = nn.Parameter(torch.zeros(*lead, d))
        self.register_buffer("mean", torch.zeros(*lead, d))
        self.register_buffer("var", torch.ones(*lead, d))

    def forward(self, x: torch.Tensor, node_mask: torch.Tensor):
        # [*lead, d] -> [*lead, 1, 1, d] against x [*lead, B, N, d]
        per = ((lambda t: t) if self.scale.dim() == 1
               else (lambda t: t[..., None, None, :]))
        if self.training:
            m = node_mask.to(x.dtype)[..., None]
            cnt = m.sum().clamp_min(1.0)
            mean = (x * m).sum((-3, -2)) / cnt
            var = (((x - per(mean)) ** 2) * m).sum((-3, -2)) / cnt
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return ((x - per(mean)) * torch.rsqrt(per(var) + self.eps)
                * per(self.scale) + per(self.bias))


class GraphiTEncoderLayer(nn.Module):
    """Returns (out [B,N,D], attn, out_each_head [B,N,H,dh] or None).

    need_heads=False: out_each_head is None and the attention output is
    fused with the output projection (vw = v_h @ Wout_h); attn is None on
    the kernel routes and the dense attention on the score route.
    need_heads=True: out_each_head holds the per-head outputs that the FeTA
    block filters spectrally, and attn is `AttnColStats` on the "flash"
    route (unless flash_need_heads is off), the dense attention
    [B, H, N, N] on the others and under a pair mask.
    """

    def __init__(self, d_model: int, n_heads: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 batch_norm: bool = False,
                 generator: Optional[torch.Generator] = None,
                 attention_impl: str = "flash", head_fold: bool = False,
                 flash_need_heads: bool = True):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} must divide evenly by "
                             f"n_heads={n_heads}")
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {attention_impl!r} is not one "
                             f"of {ATTENTION_IMPLS}")
        self.attention_impl = attention_impl
        self.head_fold = head_fold
        self.flash_need_heads = flash_need_heads
        g = generator if generator is not None else torch.Generator()
        d = d_model
        self.d_model, self.n_heads = d_model, n_heads
        self.qkv = nn.Parameter(lecun_normal_(torch.empty(d, 3 * d), g, d))
        self.qkv_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj_kernel = nn.Parameter(
            lecun_normal_(torch.empty(d, d), g, d))
        self.out_proj_bias = nn.Parameter(torch.zeros(d))
        self.ff1 = dense(d, dim_feedforward, g)
        self.ff2 = dense(dim_feedforward, d, g)
        norm = ((lambda: MaskedBatchNorm(d)) if batch_norm
                else (lambda: nn.LayerNorm(d, eps=1e-5)))
        self.norm1, self.norm2 = norm(), norm()
        self.batch_norm = batch_norm
        self.dropout = nn.Dropout(dropout)

    def _norm(self, norm, x, node_mask):
        return norm(x, node_mask) if self.batch_norm else norm(x)

    def forward(self, x, pe, node_mask, degree=None, need_heads=True,
                pair_mask=None):
        b, n, d = x.shape
        h = self.n_heads
        dh = d // h
        impl = self.attention_impl
        cdt = config.default_compute_dtype()
        bf16 = cdt == torch.bfloat16
        if bf16 and self.head_fold:
            config.refuse_bf16("the GraphiT layer's head_fold (kernels "
                               "#5-#7)", "Queue 2 item A2")
        # a float32 tensor's bf16 copy, and a bf16 result back in float32
        # (both the tensor itself off the policy, at float32 or float64)
        lo = (lambda t: t.to(cdt)) if bf16 else (lambda t: t)
        up = (lambda t: t.float()) if bf16 else (lambda t: t)
        mod_dtype = config.modulation_dtype(cdt)
        # scores as x (Wq_h Wk_h^T) x^T plus rank-1 bias terms: the kernel
        # contracts over the full d_model instead of dh
        wqkv = self.qkv.reshape(d, 3, h, dh)
        bqkv = self.qkv_bias.reshape(3, h, dh)
        wq, wk, wv = wqkv[:, 0], wqkv[:, 1], wqkv[:, 2]      # [d, h, dh]
        bq, bk, bv = bqkv[0], bqkv[1], bqkv[2]               # [h, dh]
        a_mix = torch.einsum("dhe,ghe->hdg", wq, wk)         # [h, d, d]
        xc = lo(x)
        # the input projections' weight gradients reduce over the B·N rows:
        # node_matmul takes them in blocks (ops/cheb.py's note)
        xa = node_matmul(xc[:, None], lo(a_mix))             # [B,H,N,d]
        c_q = node_matmul(x, torch.einsum("dhe,he->dh", wq, bk))  # [B,N,H]
        c_k = node_matmul(x, torch.einsum("dhe,he->dh", wk, bq))
        c_0 = torch.einsum("he,he->h", bq, bk)
        v_nhd = node_matmul(xc, lo(wv.reshape(d, h * dh))).reshape(
            b, n, h, dh) + lo(bv)                             # [B,N,H,dh]

        # the output projection's weight gradient reduces over the B·N
        # rows: node_matmul takes it in blocks (ops/cheb.py's note)
        vw = lambda: node_matmul(v_nhd.transpose(1, 2),
                                 lo(self.out_proj_kernel.reshape(h, dh, d)))
        project = lambda heads: (up(node_matmul(lo(heads.reshape(b, n, d)),
                                                lo(self.out_proj_kernel)))
                                 + self.out_proj_bias)
        kernels = pair_mask is None
        if kernels and need_heads and impl == "flash" \
                and self.flash_need_heads:
            out_each_head, s = flash_graphit_attention_heads(
                xa, x, c_q, c_k, c_0, v_nhd.transpose(1, 2), node_mask,
                pe=pe, degree=degree, head_fold=self.head_fold,
                mod_dtype=mod_dtype)
            out_each_head = up(out_each_head)
            attn_out = project(out_each_head)
            attn = AttnColStats(s=s)
        elif kernels and not need_heads and impl != "modulation":
            kw = ({} if impl == "fused"
                  else {"head_fold": self.head_fold, "mod_dtype": mod_dtype})
            fused = (fused_graphit_attention if impl == "fused"
                     else flash_graphit_attention)
            attn_out = fused(xa, x, c_q, c_k, c_0, vw(), node_mask, pe=pe,
                             degree=degree, **kw) + self.out_proj_bias
            attn = out_each_head = None
        else:
            # the score route: a plain product, then the modulation kernel
            # (under a pair mask, the plain pair-masked chain); the products whose sums run over the nodes (the scores'
            # gradients, attn @ v) in blocks (ops/cheb.py's note)
            scores = (up(node_matmul(xa, xc[:, None].transpose(-1, -2)))
                      + c_q.transpose(1, 2)[:, :, :, None]
                      + c_k.transpose(1, 2)[:, :, None, :]
                      + c_0[None, :, None, None]) / math.sqrt(dh)
            if kernels:
                attn = fused_modulated_attention(scores, node_mask, pe=pe,
                                                 degree=degree)
            else:
                _, attn = modulated_attention_from_scores(
                    scores, None, node_mask, pe=pe, degree=degree,
                    pair_mask=pair_mask, modulation_dtype=mod_dtype)
            if need_heads:
                heads = node_matmul(lo(attn), v_nhd.transpose(1, 2))
                out_each_head = heads.transpose(1, 2)        # [B,N,H,dh]
                attn_out = project(out_each_head)
                out_each_head = up(out_each_head)
            else:
                attn_out = (up(head_sum_matmul(lo(attn), vw()))
                            + self.out_proj_bias)
                out_each_head = None

        x = self._norm(self.norm1, x + self.dropout(attn_out), node_mask)
        if bf16:
            # flax's Dense(dtype=bf16): bf16 product and bias, relu and
            # dropout in bf16, back to float32 at the residual add
            ff = self.dropout(torch.relu(dense_in(self.ff1, x, cdt)))
            ff = dense_in(self.ff2, ff, cdt).float()
        else:
            ff = self.ff2(self.dropout(torch.relu(self.ff1(x))))
        x = self._norm(self.norm2, x + self.dropout(ff), node_mask)

        mask_f = node_mask.to(x.dtype)[..., None]
        if out_each_head is not None:
            out_each_head = out_each_head * mask_f[:, :, None, :]
        return x * mask_f, attn, out_each_head
