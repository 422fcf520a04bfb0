"""The bf16 compute policy (FETA_COMPUTE_DTYPE=bfloat16) of the port vs the
JAX package, on the CPU, with one torch thread.

The JAX side runs under the same environment with its flash kernels in
interpret mode (tests/test_torch_layers.py's `jax_flash_path`); the port's
wrappers run their plain versions on CPU tensors, which compute from bf16
operands in float32 and round where the JAX kernels cast. Inputs come from
numpy; bf16 operands are the same float32 numbers rounded on both sides.

Tolerances (each also in its test):
  kernels' bf16 outputs (dxa, dvw, dx)         rtol 1.6e-2 / atol 1e-3:
      two bf16 steps (a step is at most 2^-7 of a value): ds, attn and
      the outputs are rounded after float32 sums taken in other orders, so
      a value next to a rounding edge may land on the neighbour;
  the forward's outh                           rtol 1.6e-2 / atol
      2^-8 max|vw|: a kernel rounds P relative to its running row maximum
      (the JAX kernel's per key block, the plain version's the whole
      row's), so each P may differ by one rounding (2^-8 of it) and outh,
      a P-weighted mean of vw, by up to 2^-8 max|vw|;
  their float32 outputs (m, se, su, dcq, dck, colsum, diag)
      rtol 1e-4 / atol 1e-5, as tests/test_torch_kernels.py: the same
      float32 arithmetic on the same bf16 values;
  layer and model outputs                      rtol 1e-2 / atol 1e-2,
      JAX's own bf16 tests hold bf16 to float32 at atol 0.05
      (tests/test_mixed_precision.py) and 3e-2 (tests/test_flash_attention
      .py); port against JAX sits well inside;
  gradients                                    each within 1e-2 of its
      parameter's largest entry (a flipped bf16 rounding moves a gradient
      by one bf16 step of the value it feeds), or of 1e-3 where that is
      smaller: a gradient that vanishes up to rounding (a bias that a
      batch norm cancels, the key bias) is held to 1e-5;
  the biases JAX adds in bf16 (flax's Dense(dtype=bf16) biases, the
      values' third of qkv_bias): JAX's transpose of the bf16 broadcast
      sums their cotangent over the B·N rows in bf16, one row at a time
      (XLA's reduce in the operand type), the port in float32 with one
      rounding (ops/cheb.py's note). The tests capture the port's per-row
      cotangent and hold the port's gradient to its float32 sum rounded
      once (one bf16 step); one layer holds JAX's to the row-by-row bf16
      sum of those rows (two bf16 steps of the largest partial sum); the
      two-layer model, whose rows differ from JAX's by more (a ReLU gate
      next to zero flips with a bf16 rounding of the layer before), to the
      bound of JAX's sum itself: a row-by-row bf16 sum of R rows is off by
      at most (R - 1) 2^-8 of their l1 norm.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import feta_tmlr_tpu.config as jcfg
from feta_tmlr_tpu.nn import layers as jlayers
from feta_tmlr_tpu.ops import attention as jattn
from feta_tmlr_tpu.ops.pallas import flash_attention as jfl
from feta_tmlr_tpu_torch import config as tcfg
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.nn import feta as tfeta
from feta_tmlr_tpu_torch.nn import layers as tlayers
from feta_tmlr_tpu_torch.ops import attention as tattn
from feta_tmlr_tpu_torch.ops import cheb as tcheb
from feta_tmlr_tpu_torch.ops.kernels import colstat as tcs
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as tfl
from feta_tmlr_tpu_torch.ops.kernels.common import bwd_row_constants
from test_torch_kernels import _inputs
from test_torch_layers import _layer_inputs, _perturb_batch_stats

BF16_TOL = dict(rtol=1.6e-2, atol=1e-3)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
OUT_TOL = dict(rtol=1e-2, atol=1e-2)
GRAD_REL = 1e-2
GRAD_FLOOR = 1e-3
BF16_STEP = 2.0 ** -7          # the largest bf16 step relative to a value
JBF = jnp.bfloat16
TBF = torch.bfloat16


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def bf16_flash(monkeypatch, request):
    """FETA_COMPUTE_DTYPE=bfloat16 with FETA_BF16_MODULATION =
    `request.param` (default "1"); the JAX layers on the Pallas flash
    route, interpreted."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    monkeypatch.setenv("FETA_PALLAS", "1")
    monkeypatch.setenv("FETA_PALLAS_IMPL", "flash")
    monkeypatch.setattr(jcfg, "_on_accelerator", lambda: True)
    monkeypatch.setattr(jcfg, "PALLAS_AUTO_N", 0)
    monkeypatch.setenv("FETA_COMPUTE_DTYPE", "bfloat16")
    modulation = getattr(request, "param", "1")
    monkeypatch.setenv("FETA_BF16_MODULATION", modulation)
    return modulation


def _t(a):
    return torch.from_numpy(np.array(a))


def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close_bf16(got, want, **tol):
    """A port tensor against a JAX array, both bf16, compared in float32."""
    assert got.dtype == TBF and want.dtype == JBF
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **tol)


def _close_f32(got, want, **tol):
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# ------------------------------------------------------------ the policy

@pytest.mark.parametrize("value", [None, "bf16", "bfloat16", "float32",
                                   "float16"])
def test_default_compute_dtype_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("FETA_COMPUTE_DTYPE", raising=False)
    else:
        monkeypatch.setenv("FETA_COMPUTE_DTYPE", value)
    want = jcfg.default_compute_dtype()
    got = tcfg.default_compute_dtype()
    assert str(got).replace("torch.", "") == jnp.dtype(want).name
    monkeypatch.delenv("FETA_BF16_MODULATION", raising=False)
    assert tcfg.modulation_dtype(got) == (TBF if got == TBF else None)
    monkeypatch.setenv("FETA_BF16_MODULATION", "0")
    assert tcfg.modulation_dtype(got) is None


# --------------------------------------------------- kernels #1-#4 plain

def _kernel_operands(seed, mdt, dv=8, guard=False):
    """(JAX kernel-layout operands, the port's `prepare` dict, vw of each)
    under the bf16 policy with pe and deg in `mdt` ("bf16" or "f32")."""
    inp = _inputs(seed=seed, dv=dv)
    if guard:               # rows in the |su/se| <= 1e-9 branch
        inp["pe"] = inp["pe"].copy()
        inp["pe"][1, :6] = 0.0
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    jmod = JBF if mdt == "bf16" else None
    xa, x, vw = (j[k].astype(JBF) for k in ("xa", "x", "vw"))
    prep = jfl._prepare(xa, x, j["cq"], j["ck"], j["c0"], j["mask"],
                        j["pe"], j["deg"], jmod)
    ops = tfl.prepare(_t(inp["xa"]).to(TBF), _t(inp["x"]), _t(inp["cq"]),
                      _t(inp["ck"]), _t(inp["c0"]), _t(inp["mask"]),
                      _t(inp["pe"]), _t(inp["deg"]),
                      TBF if mdt == "bf16" else None)
    return (xa, x, vw, prep), ops, _t(inp["vw"]).to(TBF)


@pytest.mark.parametrize("mdt", ["bf16", "f32"])
def test_bf16_forward_and_colstat_plain_match_jax(mdt, bf16_flash):
    """#1 (outh bf16, m/se/su float32) and #2 (colsum, diag float32) with
    bf16 xa, x, vw and pe/deg in bf16 or float32, against the JAX kernels
    interpreted at block 16 (BF16_TOL, F32_TOL; outh as the module
    docstring says)."""
    (xa, x, vw, prep), ops, tvw = _kernel_operands(20, mdt)
    pe_a, deg_a, qm, km, inv_sqrt, cq_k, ck_k, c0_k = prep
    assert ops["xa"].dtype == ops["x"].dtype == TBF
    assert ops["pe"].dtype == (TBF if mdt == "bf16" else torch.float32)
    want = _jit(jfl._call_fwd, 11, 12)(xa, x, cq_k, ck_k, c0_k, vw, pe_a,
                                        deg_a, qm, km, inv_sqrt, 16, 16)
    got = tfl.flash_fwd(vw=tvw, **ops)
    _close_bf16(got[0], want[0], rtol=BF16_TOL["rtol"],
                atol=2.0 ** -8 * float(tvw.float().abs().max()))
    for g, w in zip(got[1:], want[1:]):                  # m, se, su
        _close_f32(g, w[..., 0], **F32_TOL)

    m, se, su = want[1:]
    safe = jnp.where(jnp.abs(su / se) > 1e-9, su / se, 1.0)
    wq = np.random.default_rng(21).random(m.shape).astype(np.float32)
    for w in (None, wq):
        want_cs, want_dg = _jit(jfl._call_colstat, 14, 15)(
            xa, x, cq_k, ck_k, c0_k, pe_a, deg_a, qm, km, inv_sqrt, m,
            1.0 / se, qm[:, None] / safe,
            jnp.ones_like(m) if w is None else jnp.asarray(w), 16, 16)
        sq = lambda t: _t(np.asarray(t)[..., 0])
        cs, dg = tcs.colstat(m=sq(m), se=sq(se), su=sq(su), **ops,
                             wq=None if w is None else sq(w))
        _close_f32(cs, want_cs[:, :, 0], **F32_TOL)
        _close_f32(dg, want_dg[:, :, 0], **F32_TOL)


@pytest.mark.parametrize("mdt,guard", [("bf16", True), ("f32", False)])
def test_bf16_backward_plain_matches_jax(mdt, guard, bf16_flash):
    """#3 and #4 (dxa, dvw, dx bf16; dcq, dck float32) with the row
    constants, against the JAX package's `_bwd_common` on the interpreted
    `_call_bwd` at block 16, per-head bf16 cotangent; `guard`: rows in the
    |su/se| <= 1e-9 branch, su also zeroed on 5 rows so it runs with
    c != 0."""
    (xa, x, vw, prep), ops, tvw = _kernel_operands(22, mdt, dv=4,
                                                    guard=guard)
    pe_a, deg_a, qm, km, inv_sqrt, cq_k, ck_k, c0_k = prep
    outh, m, se, su = _jit(jfl._call_fwd, 11, 12)(
        xa, x, cq_k, ck_k, c0_k, vw, pe_a, deg_a, qm, km, inv_sqrt, 16, 16)
    if guard:
        su = su.at[0, :, :5].set(0.0)
    g = jnp.asarray(np.random.default_rng(23).standard_normal(
        outh.shape).astype(np.float32)).astype(JBF)
    res = (xa, x, cq_k, ck_k, c0_k, vw, pe_a, deg_a, qm, km, inv_sqrt,
           outh, m, se, su)
    w_dxa, w_dx, w_dcq, w_dck, w_dc0, w_dvw = _jit(jfl._bwd_common, 2, 3)(
        res, g, 16, 16)[:6]

    sq = lambda t: _t(np.asarray(t)[..., 0])
    tg = _t(_f32(g)).to(TBF)
    touth = _t(_f32(outh)).to(TBF)
    consts = bwd_row_constants(tg, touth, sq(se), sq(su), ops["mask"])
    if guard:
        assert float(consts[3].abs().max()) > 1e-3       # c != 0 runs
    dxa, dcq, dvw, dck, dx = tfl.flash_bwd(
        ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"], tvw,
        ops["pe"], ops["deg"], ops["mask"], ops["inv_sqrt"], tg, sq(m),
        *consts)
    _close_bf16(dxa, w_dxa, **BF16_TOL)
    _close_bf16(dvw, w_dvw, **BF16_TOL)
    _close_bf16(dx, w_dx, **BF16_TOL)
    _close_f32(dcq, w_dcq[..., 0], **F32_TOL)
    _close_f32(dck, w_dck[:, :, 0], **F32_TOL)
    np.testing.assert_allclose(dcq.numpy().sum((0, 2)),
                               np.asarray(w_dc0).ravel(), **F32_TOL)


@pytest.mark.parametrize("heads", [False, True])
def test_bf16_flash_gradients_in_input_dtypes(heads, bf16_flash):
    """The public entry points under the policy (bf16 xa and values, pe and
    deg in bf16) through autograd: each gradient in its input's dtype (xa
    and the values bf16, x, cq, ck, c0 float32) and against jax.grad of
    the JAX entry point at its own block (the whole row at N=32, so both
    round P against the row's maximum; bf16 gradients at BF16_TOL, float32
    ones at rtol 2e-3 / atol 2e-4: they add the bf16 cotangents' products
    over the heads and keys)."""
    inp = _inputs(seed=24, dv=8)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    go = np.random.default_rng(25).standard_normal(
        (2, 32, 2, 8) if heads else (2, 32, 8)).astype(np.float32)
    jfn = (jfl.flash_graphit_attention_heads if heads
           else jfl.flash_graphit_attention)

    def jloss(xa, x, cq, ck, c0, vw):
        out = jfn(xa, x, cq, ck, c0, vw, j["mask"], pe=j["pe"],
                  degree=j["deg"], mod_dtype=JBF)
        out = out[0] if heads else out
        return (out.astype(jnp.float32) * go).sum()

    jargs = (j["xa"].astype(JBF), j["x"], j["cq"], j["ck"], j["c0"],
             j["vw"].astype(JBF))
    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(*jargs)

    targs = [_t(_f32(a)).to(TBF if a.dtype == JBF else torch.float32)
             .requires_grad_() for a in jargs]
    tfn = (tfl.flash_graphit_attention_heads if heads
           else tfl.flash_graphit_attention)
    out = tfn(*targs, _t(inp["mask"]), pe=_t(inp["pe"]),
              degree=_t(inp["deg"]), mod_dtype=TBF)
    out = out[0] if heads else out
    assert out.dtype == TBF
    (out.float() * _t(go)).sum().backward()
    for name, a, w in zip(("xa", "x", "cq", "ck", "c0", "vw"), targs, want):
        assert a.grad.dtype == a.dtype, name
        if a.dtype == TBF:
            _close_bf16(a.grad, w, **BF16_TOL)
        else:
            _close_f32(a.grad, w, rtol=2e-3, atol=2e-4)


# ------------------------------------------------------------- the layer

def _grad_close(got, want, name, scale=None):
    """Within GRAD_REL of `scale`, by default the gradient's own largest
    entry (at least GRAD_FLOOR)."""
    if scale is None:
        scale = max(float(np.abs(want).max()), GRAD_FLOOR)
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * scale,
                               err_msg=name)


def _seq_bf16_sum(rows):
    """JAX's transpose of a bf16 broadcast: rows [R, F] summed one at a
    time in bf16 (XLA's reduce in the operand type); also the largest
    partial sum."""
    acc = torch.zeros(rows.shape[1], dtype=TBF)
    peak = 0.0
    for r in rows:
        acc = (acc.float() + r.float()).to(TBF)
        peak = max(peak, float(acc.float().abs().max()))
    return acc.float().numpy(), peak


@pytest.fixture
def bf16_cotangents(monkeypatch):
    """The port's per-row cotangents at the biases that JAX adds in bf16,
    captured in the backward: "dense" {nn.Linear: [cot]} at each FFN
    Dense output, "v" {layer: [cot]} at each GraphiT layer's value
    projection (its first `node_matmul` of a bf16 [B, N, d] by a bf16
    matrix: xa's takes a 4-d operand, cq's and ck's float32 ones), "cheb"
    [cot] at the Chebyshev filter's output."""
    store = {"dense": {}, "v": {}, "cheb": []}
    cur = {}

    def keep(out, where, key=None):
        if out.requires_grad:
            out.register_hook(lambda g: (where if key is None else
                                         where.setdefault(key, [])).append(g))
        return out

    forward = tlayers.GraphiTEncoderLayer.forward

    def layer_forward(self, *a, **k):
        cur.update(layer=self, seen=False)
        return forward(self, *a, **k)

    dense = tlayers.dense_in
    matmul = tlayers.node_matmul

    def hooked_matmul(a, b):
        out = matmul(a, b)
        if (a.dtype == b.dtype == TBF and a.dim() == 3 and b.dim() == 2
                and not cur.get("seen", True)):
            cur["seen"] = True
            keep(out, store["v"], cur["layer"])
        return out

    cheb = tfeta.cheb_filter_dynamic
    monkeypatch.setattr(tlayers.GraphiTEncoderLayer, "forward",
                        layer_forward)
    monkeypatch.setattr(tlayers, "dense_in", lambda lin, x, cdt: keep(
        dense(lin, x, cdt), store["dense"], lin))
    monkeypatch.setattr(tlayers, "node_matmul", hooked_matmul)
    monkeypatch.setattr(tfeta, "cheb_filter_dynamic",
                        lambda *a: keep(cheb(*a), store["cheb"]))
    return store


def check_bf16_biases(model, want, store, emulate=True, scale=None):
    """The module docstring's bias check for every bias of `model` that
    JAX adds in bf16, from the cotangents `store` captured
    (`bf16_cotangents`) against the JAX gradients `want` (by the port's
    names): with `emulate` JAX's against the row-by-row bf16 sum, else
    within that sum's error bound, (R - 1) 2^-8 of the R rows' l1 norm;
    the q and k thirds of each qkv_bias, float32 on both sides, by
    `_grad_close` at `scale`. Returns the names checked."""
    names = {m: n for n, m in model.named_modules()}
    full = lambda m, p: f"{names[m]}.{p}" if names[m] else p
    cases = [(full(lin, "bias"), cots, 0)
             for lin, cots in store["dense"].items()]
    for layer, cots in store["v"].items():
        cases.append((full(layer, "qkv_bias"), cots, 2 * layer.d_model))
    if store["cheb"]:
        cases.append((full(model.encoder, "cheb_bias"), store["cheb"], 0))
    assert cases
    for name, (cot,), first in cases:
        rows = cot.reshape(-1, cot.shape[-1])
        got = model.get_parameter(name).grad.numpy()
        w = want[name].detach().numpy()
        if first:                        # the values' third of qkv_bias
            _grad_close(got[:first], w[:first], name, scale)
            got, w = got[first:], w[first:]
        own = rows.float().sum(0).to(TBF).float().numpy()
        np.testing.assert_allclose(got, own, rtol=BF16_STEP, atol=0,
                                   err_msg=name)
        if emulate:
            seq, peak = _seq_bf16_sum(rows)
            np.testing.assert_allclose(w, seq, rtol=0,
                                       atol=2 * BF16_STEP * peak,
                                       err_msg=name)
        else:
            l1 = rows.float().abs().sum(0).numpy()
            np.testing.assert_array_less(
                np.abs(got - w), (len(rows) - 1) * 2.0 ** -8 * l1,
                err_msg=name)
    return {name for name, _, _ in cases}


def _jax_layer():
    """The JAX layer of the layer cases and its inputs, `_layer_inputs()`."""
    x, mask, pe, deg = _layer_inputs()
    return (jlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True),
            (jnp.asarray(x), jnp.asarray(pe), jnp.asarray(mask),
             jnp.asarray(deg)))


@functools.lru_cache(maxsize=None)
def _layer_init():
    """The JAX layer's initial variables, initialised once under jit and
    shared by the layer cases: neither the route nor the policy changes
    them, and an eager init runs the interpreted kernels op by op."""
    layer, jargs = _jax_layer()
    return jax.jit(layer.init)(jax.random.key(0), *jargs)


# (route, FETA_BF16_MODULATION, need_heads): the flash route's float32 pe
# and deg take the filtered layer, which runs #1-#4 and colstat
LAYER_CASES = [("flash", "1", False), ("flash", "1", True),
               ("flash", "0", True), ("modulation", "1", False),
               ("modulation", "1", True)]


@pytest.mark.parametrize("impl,bf16_flash,need_heads", LAYER_CASES,
                         indirect=["bf16_flash"])
def test_bf16_layer_matches_jax(impl, need_heads, bf16_flash, monkeypatch,
                                bf16_cotangents):
    """One GraphiT layer in train mode under the policy on the "flash"
    route (pe/deg in bf16 and in float32) and on "modulation" (the JAX
    layer's modulation kernel on float32 scores): outputs (OUT_TOL) and
    gradients w.r.t. the input and every parameter (GRAD_REL; the bf16
    biases by `check_bf16_biases`)."""
    monkeypatch.setenv("FETA_PALLAS_IMPL", impl)
    x, mask, pe, deg = _layer_inputs()
    layer, jargs = _jax_layer()
    variables = _perturb_batch_stats(
        dict(_layer_init()), np.random.default_rng(8))
    rng = np.random.default_rng(9)
    variables["params"] = jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        variables["params"])
    g_out = rng.standard_normal(x.shape).astype(np.float32)
    g_heads = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)

    def jloss(params, xin):
        (o, _, hd), _ = layer.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            xin, *jargs[1:], deterministic=False, need_heads=need_heads,
            mutable=["batch_stats"])
        loss = (o * g_out).sum()
        return (loss + (hd * g_heads).sum() if need_heads else loss), (o, hd)

    (_, (w_out, w_heads)), (w_params, w_x) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(variables["params"], jargs[0])

    port = from_flax(_np(variables), tlayers.GraphiTEncoderLayer(
        16, 2, 32, 0.0, True, attention_impl=impl)).train()
    tx = _t(x).requires_grad_()
    out, _, heads = port(tx, _t(pe), _t(mask), _t(deg),
                         need_heads=need_heads)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(w_out),
                               **OUT_TOL)
    loss = (out * _t(g_out)).sum()
    if need_heads:
        assert heads.dtype == torch.float32
        np.testing.assert_allclose(heads.detach().numpy(),
                                   np.asarray(w_heads), **OUT_TOL)
        loss = loss + (heads * _t(g_heads)).sum()
    loss.backward()
    _grad_close(tx.grad.numpy(), np.asarray(w_x), "x")
    want = dict(from_flax({"params": _np(w_params),
                           "batch_stats": _np(variables["batch_stats"])},
                          tlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True)
                          ).named_parameters())
    biases = check_bf16_biases(port, want, bf16_cotangents)
    assert biases == {"ff1.bias", "ff2.bias", "qkv_bias"}
    for name, p in port.named_parameters():
        if name not in biases:
            _grad_close(p.grad.numpy(), want[name].detach().numpy(), name)


def test_bf16_pair_masked_chain_matches_jax(monkeypatch):
    """The packed rows' plain chain with `modulation_dtype` bf16 (its
    route under the policy) against JAX's: attention in bf16, the softmax
    in float32 before it (BF16_TOL)."""
    rng = np.random.default_rng(30)
    b, h, n = 2, 2, 24
    s = rng.standard_normal((b, h, n, n)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[0, n - 4:] = False
    seg = np.repeat(np.arange(3), 8)
    pair = (seg[:, None] == seg[None, :])[None] & mask[:, :, None] \
        & mask[:, None, :]
    pe = rng.random((b, n, n)).astype(np.float32)
    deg = rng.random((b, n)).astype(np.float32)
    _, want = jattn.modulated_attention_from_scores(
        jnp.asarray(s), None, jnp.asarray(mask), pe=jnp.asarray(pe),
        degree=jnp.asarray(deg), pair_mask=jnp.asarray(pair),
        values_needed=False, modulation_dtype=JBF)
    _, got = tattn.modulated_attention_from_scores(
        _t(s), None, _t(mask), pe=_t(pe), degree=_t(deg),
        pair_mask=_t(pair), modulation_dtype=TBF)
    _close_bf16(got, want, **BF16_TOL)


# -------------------------------------------------------------- refusals

def _families(atoms=4, bonds=2):
    from feta_tmlr_tpu_torch.nn.gat import GATFeTANet, GATNet
    from feta_tmlr_tpu_torch.nn.gatedgcn import GatedGCNLSPENet
    from feta_tmlr_tpu_torch.nn.lspe import GraphiTSpectraNet
    from feta_tmlr_tpu_torch.nn.pna import PNALSPENet
    from feta_tmlr_tpu_torch.nn.san import SANNet, SANNodeSpectra
    from feta_tmlr_tpu_torch.nn.san_lspe import SANLSPENet
    two = dict(num_atom_type=atoms, num_bond_type=bonds, device="cpu")
    return {"SANNet": lambda: SANNet(**two),
            "SANNodeSpectra": lambda: SANNodeSpectra(**two),
            "GATNet": lambda: GATNet(num_atom_type=atoms, device="cpu"),
            "GATFeTANet": lambda: GATFeTANet(num_atom_type=atoms,
                                             device="cpu"),
            "GraphiTSpectraNet": lambda: GraphiTSpectraNet(**two),
            "SANLSPENet": lambda: SANLSPENet(**two),
            "GatedGCNLSPENet": lambda: GatedGCNLSPENet(**two),
            "PNALSPENet": lambda: PNALSPENet(**two)}


REFUSALS = ["head_fold", "GraphiTSpectraNet", "SANLSPENet",
            "GatedGCNLSPENet", "PNALSPENet"]
# run under the policy since the bf16 fused pair and fused MLP pair
# (tests/test_torch_bf16_lpe.py holds them to JAX)
RUNS = ["fused", "SANNet", "SANNodeSpectra", "GATNet", "GATFeTANet"]


@pytest.mark.parametrize("what", REFUSALS)
def test_bf16_refusals_name_the_roadmap_item(what, monkeypatch):
    """What has no bf16 path in the port raises NotImplementedError naming
    its ROADMAP item under the policy, and builds in float32 without it:
    `head_fold` (Queue 2 item A2) when a layer runs, the four LSPE
    families (Queue 1 item 4) when a net is built."""
    monkeypatch.setenv("FETA_COMPUTE_DTYPE", "bf16")
    if what == "head_fold":
        layer = tlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, head_fold=True)
        x, mask, pe, deg = _layer_inputs(n=8, pad=2)
        with pytest.raises(NotImplementedError, match="Queue 2 item A2"):
            layer(_t(x), _t(pe), _t(mask), _t(deg), need_heads=False)
        monkeypatch.setenv("FETA_COMPUTE_DTYPE", "float32")
        layer(_t(x), _t(pe), _t(mask), _t(deg), need_heads=False)
        return
    build = _families()[what]
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        build()
    monkeypatch.delenv("FETA_COMPUTE_DTYPE")
    build()


@pytest.mark.parametrize("what", RUNS)
def test_bf16_builds_and_runs_one_forward_under_the_policy(what,
                                                           monkeypatch):
    """What the bf16 fused pair and MLP pair made runnable under the
    policy builds and runs one forward there, finite and float32 at the
    output, and moved by the policy: the GraphiT layer on the "fused"
    route, the SAN and GAT nets (at their default widths, on the graphs of
    tests/test_torch_san_family.py)."""
    monkeypatch.setenv("FETA_COMPUTE_DTYPE", "bf16")
    if what == "fused":
        layer = tlayers.GraphiTEncoderLayer(16, 2, 32, 0.0,
                                            attention_impl="fused").eval()
        x, mask, pe, deg = _layer_inputs(n=8, pad=2)
        run = lambda: layer(_t(x), _t(pe), _t(mask), _t(deg),
                            need_heads=False)[0]
    else:
        from test_torch_san_family import BASE, lpe_batches
        model = _families(BASE["num_atom_type"],
                          BASE["num_bond_type"])[what]().eval()
        _, tb = lpe_batches()
        run = lambda: model(tb)
    with torch.inference_mode():
        out = run()
        monkeypatch.setenv("FETA_COMPUTE_DTYPE", "float32")
        out32 = run()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert out.shape == out32.shape
    assert not torch.equal(out, out32)


def test_bf16_products_round_once():
    """`ops/cheb.py` under bf16 operands: each product is the float32
    product of their values rounded once, blocked or not (a contraction
    of 200 nodes: four blocks of 64), the heads' sum included."""
    rng = np.random.default_rng(31)
    a = _t(rng.standard_normal((2, 3, 5, 200)).astype(np.float32)).to(TBF)
    b = _t(rng.standard_normal((2, 3, 200, 7)).astype(np.float32)).to(TBF)
    once = (a.double() @ b.double()).to(TBF)
    for fn in (tcheb.blocked_matmul, tcheb.node_matmul, tcheb.matmul):
        got = fn(a, b)
        assert got.dtype == TBF
        np.testing.assert_allclose(got.float().numpy(),
                                   once.float().numpy(), rtol=BF16_STEP,
                                   atol=0)
    got = tcheb.head_sum_matmul(a, b)
    want = (a.double() @ b.double()).sum(1).to(TBF)
    assert got.dtype == TBF
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=BF16_STEP, atol=0)
