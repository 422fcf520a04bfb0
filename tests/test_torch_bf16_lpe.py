"""The bf16 compute policy (FETA_COMPUTE_DTYPE=bfloat16) of the port vs the
JAX package, on the CPU, with one torch thread: the fused attention pair
(#10/#11), the fused MLP pair (#12/#13), the GraphiT layer on the "fused"
route, and the LPE codebase (SANNet, SANNodeSpectra, GATNet, GATFeTANet).

The JAX side runs under the same environment with its Pallas kernels in
interpret mode: the fused pair through `_call_fwd` / `_call_bwd` and its
custom VJP, the MLP pair through `fused_mlp` (the SAN eigen-PE head's
fused branch, `FETA_FUSED_MLP=1`, which on the CPU JAX takes only when
asked). The port's wrappers run their plain versions on CPU tensors, which
compute from bf16 operands in float32 and round where the JAX kernels
cast. Inputs come from numpy with a seed; bf16 operands are the same
float32 numbers rounded on both sides.

Tolerances (each also in its test):
  the kernels' bf16 outputs (out, dxa, dx, dvw, y, dx of the MLP)
      rtol 1.6e-2 / atol 1e-3: two bf16 steps (a step is at most 2^-7 of a
      value); attn, ds, h and dh are rounded after float32 sums taken in
      other orders (and exp on another library), so a value next to a
      rounding edge may land on the neighbour;
  their float32 outputs (dcq, dck, dc0, the MLP's dW and db)
      rtol 1e-4 / atol 1e-5 where they sum unrounded values (dcq, dck,
      dc0, db1, db2); dW1 and dW2, sums of rounded dh and h, within 1e-2
      of their largest entry (a flipped rounding of one dh moves them by
      one bf16 step of it);
  layer and model outputs and gradients: as tests/test_torch_mixed_
      precision.py (OUT_TOL; GRAD_REL of each parameter's largest
      gradient, GRAD_FLOOR; the biases that JAX adds in bf16 within the
      bound of a row-by-row bf16 sum, `check_bf16_biases`' reasoning).
"""

import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from feta_tmlr_tpu.nn import gat as jgat
from feta_tmlr_tpu.nn import san as jsan
from feta_tmlr_tpu.ops.pallas import fused_attention as jfa
from feta_tmlr_tpu.ops.pallas import fused_mlp as jfm
from feta_tmlr_tpu.train.trainer import TrainConfig as JTrainConfig
from feta_tmlr_tpu.train.trainer import Trainer as JTrainer
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.nn import gat as tgat
from feta_tmlr_tpu_torch.nn import layers as tlayers
from feta_tmlr_tpu_torch.nn import san as tsan
from feta_tmlr_tpu_torch.ops.kernels import fused_attention as tfa
from feta_tmlr_tpu_torch.ops.kernels import fused_mlp as tfm
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as tfl
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
from test_torch_fused_attention import _inputs as fused_inputs
from test_torch_gat import GAT
from test_torch_layers import _layer_inputs, _perturb_batch_stats
from test_torch_mixed_precision import (  # noqa: F401 (fixtures)
    BF16_STEP,
    OUT_TOL,
    _grad_close,
    _jax_layer,
    _layer_init,
    bf16_cotangents,
    bf16_flash,
    check_bf16_biases,
)
from test_torch_mixed_precision import _np as _mp_np
from test_torch_san import fused_interpret, no_freq_dropout  # noqa: F401
from test_torch_san_family import BASE, lpe_batches, random_variables

BF16_TOL = dict(rtol=1.6e-2, atol=1e-3)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 1e-2           # as tests/test_torch_mixed_precision.py
F64_FACTOR = 2            # the nets' gradients off float64, over JAX's
JBF = jnp.bfloat16
TBF = torch.bfloat16
VALUES = ("xa", "x", "vw", "g")     # bf16 operands of the fused pair
MLP_VALUES = ("x", "w1", "w2", "g")  # and of the fused MLP


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, err_msg="", **tol):
    """A port tensor against a JAX array of the same dtype (bf16 or
    float32), compared in float32."""
    assert (got.dtype == TBF) == (jnp.asarray(want).dtype == JBF), err_msg
    np.testing.assert_allclose(got.detach().float().numpy(), _f32(want),
                               err_msg=err_msg, **tol)


def _scaled_close(got, want, name, rel=GRAD_REL):
    want = _f32(want)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * scale, err_msg=name)


# ----------------------------------------------------- fused pair #10/#11

def _bf16_fused(seed, with_mod=True):
    """`fused_inputs` (three graphs, two padded, guard rows in one) with
    xa, x, vw and g rounded to bf16 (float32 arrays of bf16 values);
    pe/degree float32 (the fused pair takes them so)."""
    inp = fused_inputs(seed=seed, b=3, h=2, n=16, d=16)
    for k in VALUES:
        inp[k] = _f32(jnp.asarray(inp[k]).astype(JBF))
    if not with_mod:
        inp["pe"] = inp["deg"] = None
    return inp


def _j(inp, k):
    """inp[k] for JAX: bf16 where it is one of VALUES."""
    return jnp.asarray(inp[k]).astype(JBF if k in VALUES else jnp.float32)


def _tv(inp, k):
    """inp[k] for the port: bf16 where it is one of VALUES."""
    t = _t(inp[k])
    return t.to(TBF) if k in VALUES else t


def _kernel_layout(inp):
    """The JAX kernels' operands (`_call_fwd` / `_call_bwd`) and the
    port's (`prepare`)."""
    b, h, n, d = inp["xa"].shape
    f32 = jnp.float32
    j = lambda k: _j(inp, k)
    pe = j("pe") if inp["pe"] is not None else jnp.ones((b, n, n), f32)
    deg = j("deg") if inp["deg"] is not None else jnp.ones((b, n), f32)
    mask = j("mask").astype(f32)
    jops = (j("xa"), j("x"), j("cq").transpose(0, 2, 1)[..., None],
            j("ck").transpose(0, 2, 1)[:, :, None, :],
            j("c0").reshape(h, 1, 1), j("vw"), pe, deg.reshape(b, 1, n),
            mask.reshape(b, n, 1), mask.reshape(b, 1, n),
            jnp.full((1, 1), 1.0 / (d // h) ** 0.5, f32))
    tops = tfl.prepare(*(_tv(inp, k) for k in ("xa", "x", "cq", "ck", "c0")),
                       _t(inp["mask"]), _t(inp["pe"]), _t(inp["deg"]))
    return jops, tops


@pytest.mark.parametrize("with_mod", [True, False])
def test_bf16_fused_forward_plain_matches_jax(with_mod, interpret_mode):
    """#10's plain bf16 version against the interpreted JAX `_call_fwd` on
    bf16 xa, x, vw (attn rounded to bf16 before P·V, out rounded once):
    BF16_TOL."""
    inp = _bf16_fused(11, with_mod)
    jops, tops = _kernel_layout(inp)
    want = jfa._call_fwd(*jops)
    got = tfa.fused_attn_fwd(vw=_tv(inp, "vw"), **tops)
    assert tops["xa"].dtype == tops["x"].dtype == TBF
    assert tops["pe"] is None or tops["pe"].dtype == torch.float32
    _close(got, want, "out", **BF16_TOL)


@pytest.mark.parametrize("with_mod", [True, False])
def test_bf16_fused_backward_plain_matches_jax(with_mod, interpret_mode):
    """#11's plain bf16 version against the interpreted JAX `_call_bwd`:
    dxa, dx, dvw bf16 (BF16_TOL), dcq, dck, dc0 float32 (F32_TOL), with
    guard rows in graph 1."""
    inp = _bf16_fused(12, with_mod)
    b, h, n, d = inp["xa"].shape
    jops, tops = _kernel_layout(inp)
    want = jfa._call_bwd(*jops, _j(inp, "g"))
    got = tfa.fused_attn_bwd(vw=_tv(inp, "vw"), g=_tv(inp, "g"), **tops)
    shapes = [(b, h, n, d), (b, n, d), (b, h, n), (b, h, n), (b, h),
              (b, h, n, d)]
    for name, gt, w, shape in zip(("dxa", "dx", "dcq", "dck", "dc0", "dvw"),
                                  got, want, shapes):
        tol = BF16_TOL if gt.dtype == TBF else F32_TOL
        _close(gt, jnp.asarray(w).reshape(shape), name, **tol)


def test_bf16_fused_gradients_in_input_dtypes(interpret_mode):
    """`fused_graphit_attention` (FusedGraphiT) on bf16 xa and vw and a
    float32 x: out bf16; each gradient in its input's dtype (xa, vw bf16;
    x, cq, ck, c0 float32) and against jax.vjp of the JAX entry point on
    the same operands (bf16 ones BF16_TOL; float32 ones within GRAD_REL of
    their largest entry: dx is the bf16 kernel gradient cast back)."""
    inp = _bf16_fused(13)
    names = ("xa", "x", "cq", "ck", "c0", "vw")
    inp["x"] = fused_inputs(seed=13, b=3, h=2, n=16, d=16)["x"]
    kw = dict(pe=jnp.asarray(inp["pe"]), degree=jnp.asarray(inp["deg"]))
    mask = jnp.asarray(inp["mask"])
    fn = lambda *a: jfa.fused_graphit_attention(*a, mask, **kw)
    leaf = lambda k: k in ("xa", "vw")          # bf16 leaves; x float32
    jargs = tuple(_j(inp, k) if leaf(k) else jnp.asarray(inp[k])
                  for k in names)
    out_j, vjp = jax.vjp(fn, *jargs)
    want = vjp(_j(inp, "g"))
    args = [(_tv(inp, k) if leaf(k) else _t(inp[k])).requires_grad_()
            for k in names]
    out = tfa.fused_graphit_attention(*args, _t(inp["mask"]),
                                      pe=_t(inp["pe"]),
                                      degree=_t(inp["deg"]))
    assert out.dtype == TBF and out_j.dtype == JBF
    _close(out, out_j, "out", **BF16_TOL)
    out.backward(_tv(inp, "g"))
    for name, a, w in zip(names, args, want):
        assert a.grad.dtype == a.dtype, name
        if a.dtype == TBF:
            _close(a.grad, w, name, **BF16_TOL)
        else:
            _scaled_close(a.grad, w, name)


# ------------------------------------------------------ fused MLP #12/#13

def _mlp(seed, r=40, din=8, f=64, dout=8):
    """bf16 x, w1, w2, g and float32 b1, b2 as float32 arrays holding
    bf16 values where bf16."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    bf = lambda a: _f32(jnp.asarray(a).astype(JBF))
    return dict(x=bf(n(r, din)), w1=bf(0.4 * n(din, f)), b1=0.2 * n(f),
                w2=bf(0.2 * n(f, dout)), b2=0.2 * n(dout),
                g=bf(n(r, dout)))


def test_bf16_mlp_plain_matches_jax(interpret_mode):
    """#12 and #13's plain bf16 versions at rate 0 against the interpreted
    JAX kernels (`_call_fwd`, `_call_bwd` on bf16 x, w1, w2, g and
    float32 biases, rows a multiple of the block): y and dx bf16
    (BF16_TOL), db1 and db2 float32 (F32_TOL), dW1 and dW2 float32 sums
    of rounded dh and h (GRAD_REL of their largest entry)."""
    m = _mlp(21)
    j = {k: jnp.asarray(v).astype(JBF if k in MLP_VALUES else jnp.float32)
         for k, v in m.items()}
    seed = jnp.zeros((1, 1), jnp.float32)
    want_y = jfm._call_fwd(seed, j["x"], j["w1"], j["b1"].reshape(1, -1),
                           j["w2"], j["b2"].reshape(1, -1), 0.0, 8)
    want = jfm._call_bwd(seed, j["x"], j["w1"], j["b1"].reshape(1, -1),
                         j["w2"], j["g"], 0.0, 8)
    t = {k: _t(v).to(TBF) if k in MLP_VALUES else _t(v)
         for k, v in m.items()}
    y = tfm.fused_mlp_fwd(t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
    _close(y, want_y, "y", **BF16_TOL)
    got = tfm.fused_mlp_bwd(t["x"], t["w1"], t["b1"], t["w2"], t["g"])
    for name, gt, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        w = jnp.asarray(w).reshape(gt.shape)
        if name in ("dw1", "dw2"):
            assert gt.dtype == torch.float32
            _scaled_close(gt, w, name)
        else:
            _close(gt, w, name, **(BF16_TOL if gt.dtype == TBF
                                   else F32_TOL))


def test_bf16_mlp_gradients_rounded_once(interpret_mode):
    """`fused_mlp` (FusedMLP) on bf16 x, w1, w2 and float32 b1, b2 (the
    eigen-PE head's casts): y bf16; dx, dW1, dW2 bf16 and db1, db2 float32,
    each gradient in its input's dtype. dW1 and dW2 are the plain
    backward's float32 sums rounded once (bit for bit), and all of them
    agree with jax.vjp of the JAX `fused_mlp` at rate 0 (BF16_TOL /
    F32_TOL; dW1, dW2 GRAD_REL)."""
    m = _mlp(22)
    names = ("x", "w1", "b1", "w2", "b2")
    jargs = [jnp.asarray(m[k]).astype(JBF if k in ("x", "w1", "w2")
                                      else jnp.float32) for k in names]
    y_j, vjp = jax.vjp(lambda *a: jfm.fused_mlp(*a, block_rows=8), *jargs)
    want = vjp(jnp.asarray(m["g"]).astype(JBF))
    args = [(_t(m[k]).to(TBF) if k in ("x", "w1", "w2") else _t(m[k])
             ).requires_grad_() for k in names]
    y = tfm.fused_mlp(*args)
    assert y.dtype == TBF
    _close(y, y_j, "y", **BF16_TOL)
    y.backward(_t(m["g"]).to(TBF))
    with torch.no_grad():
        plain = tfm.fused_mlp_bwd_plain(*(a.detach() for a in args[:4]),
                                        _t(m["g"]).to(TBF))
    assert torch.equal(args[1].grad, plain[1].to(TBF))
    assert torch.equal(args[3].grad, plain[3].to(TBF))
    for name, a, w in zip(names, args, want):
        assert a.grad.dtype == a.dtype, name
        if name in ("w1", "w2"):
            _scaled_close(a.grad, w, name)
        else:
            _close(a.grad, w, name, **(BF16_TOL if a.dtype == TBF
                                       else F32_TOL))


def test_bf16_mlp_operands_checked():
    """The MLP's operand rule: bf16 values take float32 biases; a bf16
    bias, or values of mixed dtypes, raise naming the operand."""
    m = _mlp(23)
    t = {k: _t(v) for k, v in m.items()}
    bf = {k: v.to(TBF) for k, v in t.items()}
    # the check runs ahead of a CUDA launch; call it directly on the CPU
    with pytest.raises(ValueError, match="b1 must be float32"):
        tfm._check("fused_mlp_fwd", bf["x"], bf["w1"], bf["b1"], bf["w2"],
                   [])
    with pytest.raises(ValueError, match="w2 must be bfloat16"):
        tfm._check("fused_mlp_fwd", bf["x"], bf["w1"], t["b1"], t["w2"], [])
    assert tfm._check("fused_mlp_fwd", bf["x"], bf["w1"], t["b1"],
                      bf["w2"], [("b2", t["b2"], (8,))]) == (40, 8, 64, 8)
    assert tfm._values_dtype(bf["x"]) == ("_bf16", TBF)
    assert tfm._values_dtype(t["x"]) == ("", torch.float32)


# ------------------------------------------- the GraphiT layer on "fused"

@pytest.mark.parametrize("need_heads", [False, True])
def test_bf16_fused_layer_matches_jax(need_heads, bf16_flash, monkeypatch,
                                      bf16_cotangents):
    """One GraphiT layer in train mode under the policy on the "fused"
    route against the JAX layer with FETA_PALLAS_IMPL=fused, interpreted:
    the unfiltered layer through the fused pair (bf16 xa, x, vw; float32
    pe and degree), the filtered one through the score route and the
    float32 modulation kernel; outputs (OUT_TOL) and the gradients of the
    input and every parameter (GRAD_REL; the biases JAX adds in bf16 by
    `check_bf16_biases`)."""
    monkeypatch.setenv("FETA_PALLAS_IMPL", "fused")
    x, mask, pe, deg = _layer_inputs()
    layer, jargs = _jax_layer()
    variables = _perturb_batch_stats(dict(_layer_init()),
                                     np.random.default_rng(18))
    rng = np.random.default_rng(19)
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
    port = from_flax(_mp_np(variables), tlayers.GraphiTEncoderLayer(
        16, 2, 32, 0.0, True, attention_impl="fused")).train()
    tx = _t(x).requires_grad_()
    with launch_spy() as calls:
        out, _, heads = port(tx, _t(pe), _t(mask), _t(deg),
                             need_heads=need_heads)
    assert calls == ({"modulation_fwd"} if need_heads
                     else {"fused_attn_fwd"})
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(w_out),
                               **OUT_TOL)
    loss = (out * _t(g_out)).sum()
    if need_heads:
        np.testing.assert_allclose(heads.detach().numpy(),
                                   np.asarray(w_heads), **OUT_TOL)
        loss = loss + (heads * _t(g_heads)).sum()
    loss.backward()
    _grad_close(tx.grad.numpy(), np.asarray(w_x), "x")
    want = dict(from_flax({"params": _mp_np(w_params),
                           "batch_stats": _mp_np(variables["batch_stats"])},
                          tlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True)
                          ).named_parameters())
    biases = check_bf16_biases(port, want, bf16_cotangents)
    assert biases == {"ff1.bias", "ff2.bias", "qkv_bias"}
    for name, p in port.named_parameters():
        if name not in biases:
            _grad_close(p.grad.numpy(), want[name].detach().numpy(), name)


@contextlib.contextmanager
def launch_spy():
    """The names of the kernel wrappers the GraphiT layer calls (their
    plain versions run on CPU tensors)."""
    calls = set()
    wraps = {"fused_graphit_attention": ("fused_attn_fwd", tlayers),
             "fused_modulated_attention": ("modulation_fwd", tlayers),
             "flash_graphit_attention": ("flash_fwd", tlayers)}
    saved = {k: getattr(mod, k) for k, (_, mod) in wraps.items()}

    def spy(key, fn):
        def run(*a, **k):
            calls.add(wraps[key][0])
            return fn(*a, **k)
        return run

    for k, (_, mod) in wraps.items():
        setattr(mod, k, spy(k, saved[k]))
    try:
        yield calls
    finally:
        for k, (_, mod) in wraps.items():
            setattr(mod, k, saved[k])


# ------------------------------------------------------- the LPE codebase

TRAIN = dict(task="graph_reg", lr=1e-3, weight_decay=1e-5, sign_flip=False)
NETS = {
    "SANNodeSpectra": ("SANNodeSpectra", dict(BASE, filter_order=3)),
    "SANNet-none": ("SANNet", dict(BASE, lpe="none")),
    "SANNet-node": ("SANNet", dict(BASE, lpe="node")),
    "SANNet-edge": ("SANNet", dict(BASE, lpe="edge")),
    "GATNet": ("GATNet", GAT),
    "GATFeTANet": ("GATFeTANet", dict(GAT, filter_order=3)),
}


def as_float64(batch):
    """A port batch with its floating-point fields in float64."""
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).double()
        for f in dataclasses.fields(batch)
        if torch.is_tensor(getattr(batch, f.name))
        and getattr(batch, f.name).is_floating_point()})


def as_written(fn, *args):
    """fn(*args) compiled with XLA's excess precision off: every bf16
    rounding of the JAX program is taken where its casts put it. With it
    on (XLA's default) a fusion may keep a bf16 intermediate in float32,
    and a rounding that the port takes is skipped: a bf16 score next to
    the clip's bound of 5 is a tie there (gradient 1/2) and not under jit
    (the gradients of SAN's fake-edge projections moved by a third)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.fixture
def bias_rows(monkeypatch):
    """The port's per-row cotangents at the biases that JAX adds in bf16
    (flax's Dense(dtype=bf16) biases: the eigen-PE head's qkv, the SAN
    filter's filt_linear; the Chebyshev filter's bias), captured in the
    backward: {"dense": {Linear: [cot]}, "cheb": {call index: cot}} (the
    filter's calls in forward order, one a filtered layer)."""
    store = {"dense": {}, "cheb": {}}
    dense, cheb = tsan.dense_in, tsan.cheb_filter_scalar_coeff

    def hooked_dense(lin, x, cdt):
        out = dense(lin, x, cdt)
        if cdt == TBF and lin.bias is not None and out.requires_grad:
            out.register_hook(
                lambda g: store["dense"].setdefault(lin, []).append(g))
        return out

    def hooked_cheb(*a):
        out = cheb(*a)
        if out.dtype == TBF and out.requires_grad:
            i = len(store["cheb"])
            store["cheb"][i] = None
            out.register_hook(lambda g: store["cheb"].__setitem__(i, g))
        return out

    monkeypatch.setattr(tsan, "dense_in", hooked_dense)
    monkeypatch.setattr(tsan, "cheb_filter_scalar_coeff", hooked_cheb)
    return store


def check_bias_rows(model, want, store):
    """Each bias that JAX adds in bf16: the port's gradient its captured
    rows' float32 sum rounded once (one bf16 step), JAX's within the error
    bound of its row-by-row bf16 sum, (R - 1) 2^-8 of the R rows' l1 norm
    (tests/test_torch_mixed_precision.py's note). Returns their names."""
    names = {m: n for n, m in model.named_modules()}
    cases = [(f"{names[lin]}.bias", cot) for lin, (cot,) in
             store["dense"].items()]
    filtered = [n for n, m in model.named_modules()
                if hasattr(m, "cheb_bias")]
    assert len(filtered) == len(store["cheb"])
    cases += [(f"{layer}.cheb_bias", store["cheb"][i])
              for i, layer in enumerate(filtered)]
    for name, cot in cases:
        rows = cot.reshape(-1, cot.shape[-1])
        got = model.get_parameter(name).grad.numpy()
        own = rows.float().sum(0).to(TBF).float().numpy()
        np.testing.assert_allclose(got, own, rtol=BF16_STEP, atol=0,
                                   err_msg=name)
        l1 = rows.float().abs().sum(0).numpy()
        np.testing.assert_array_less(
            np.abs(got - want[name]),
            (len(rows) - 1) * 2.0 ** -8 * l1 + 1e-30, err_msg=name)
    return {name for name, _ in cases}


@pytest.mark.parametrize("net", list(NETS))
def test_bf16_lpe_net_logits_and_trainer_step_match_jax(
        net, monkeypatch, fused_interpret, no_freq_dropout, bias_rows):
    """Under the policy, the JAX net's eval logits (its FreqTransformer on
    the Pallas fused-MLP route, interpreted) and one step of its Trainer
    (`_loss_and_grads`: L1, sign flip off, the eigen-PE head's dropout 0
    on both sides), both compiled `as_written`, against the port's net
    through `from_flax` and one port `Trainer` step: logits and loss
    OUT_TOL; the biases JAX adds in bf16 by `check_bias_rows`; every other
    gradient within GRAD_REL of the step's largest entry of JAX's or,
    where it is not, with an error from the float64 step (the port's net
    in float64 with the policy off) at most F64_FACTOR times JAX's bf16
    step's. The bf16 gradients of these nets are noisy on either side: a
    bf16 score lands on the clip's bound of 5 (a tie), and XLA's
    reductions in bf16 (the broadcast Chebyshev coefficients, the
    typed-edge table) round at each row where the port's take float32
    sums (`check_bias_rows`' note), which moves the SAN filter's
    coefficient head and, through layer 0, the eigen-PE head by a few per
    cent of their own largest entries. The port's input to the readout
    moves with the policy, and its parameters and gradients stay
    float32."""
    monkeypatch.setenv("FETA_COMPUTE_DTYPE", "bfloat16")
    cls, kw = NETS[net]
    jmod = jgat if cls.startswith("GAT") else jsan
    tmod = tgat if cls.startswith("GAT") else tsan
    jb, tb = lpe_batches()
    jmodel = getattr(jmod, cls)(**kw)
    variables = random_variables(jmodel, jb)
    want = as_written(jmodel.apply, variables, jb)
    port = from_flax(variables, getattr(tmod, cls)(**kw, device="cpu"))
    readout_in = []
    port.mlp_readout.register_forward_hook(
        lambda mod, a, out: readout_in.append(a[0]))
    with torch.inference_mode():
        got = port.eval()(tb)
        monkeypatch.delenv("FETA_COMPUTE_DTYPE")
        port(tb)
        monkeypatch.setenv("FETA_COMPUTE_DTYPE", "bfloat16")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    assert not torch.equal(*readout_in)         # the policy is on

    jtr = JTrainer(jmodel, JTrainConfig(**TRAIN))
    args = ({"params": variables["params"]}, variables.get("batch_stats", {}),
            jb, jax.random.key(1))
    jloss, jgrads, _ = as_written(jtr._loss_and_grads, *args)
    monkeypatch.delenv("FETA_COMPUTE_DTYPE")
    ref = from_flax(variables, getattr(tmod, cls)(**kw, device="cpu"))
    ref = ref.to(torch.float64)
    if hasattr(ref, "pe_transformer"):
        ref.pe_transformer.freq_transformer.dropout = 0.0
    Trainer(ref, TrainConfig(**TRAIN)).step(as_float64(tb))
    monkeypatch.setenv("FETA_COMPUTE_DTYPE", "bfloat16")
    port = from_flax(variables, getattr(tmod, cls)(**kw, device="cpu"))
    if hasattr(port, "pe_transformer"):
        port.pe_transformer.freq_transformer.dropout = 0.0
    loss = Trainer(port, TrainConfig(**TRAIN)).step(tb)
    np.testing.assert_allclose(float(loss), float(jloss), **OUT_TOL)
    by_name = lambda g: {n: p.detach().numpy() for n, p in from_flax(
        {"params": _mp_np(g["params"]),
         "batch_stats": _mp_np(variables.get("batch_stats", {}))},
        getattr(tmod, cls)(**kw, device="cpu")).named_parameters()}
    grads = by_name(jgrads)
    f64 = {n: p.grad.numpy() for n, p in ref.named_parameters()}
    scale = max(float(np.abs(w).max()) for w in grads.values())
    biases = check_bias_rows(port, grads, bias_rows)
    for name, p in port.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        if name not in biases:
            got = p.grad.numpy()
            if np.abs(got - grads[name]).max() <= GRAD_REL * scale:
                continue
            err = lambda g: float(np.abs(g - f64[name]).max())
            assert err(got) <= F64_FACTOR * err(grads[name]), (
                name, err(got), err(grads[name]))


# ------------------------------------------- the LPE config trainer, bf16

@pytest.mark.parametrize("config", ["configs/LPE/ZINC/optimized.json",
                                    "configs/LPE/ZINC_GATFeTA_optimized.json"],
                         ids=["SAN_NodeLPE", "GATFeTA"])
def test_bf16_lpe_config_trainer_resumes_bit_for_bit(config, tmp_path,
                                                     monkeypatch):
    """`main_ZINC_graph_regression` over the config as written, under the
    policy on the ZINC fixture: one epoch into a checkpoint directory and
    a resume to two give every logged number but the times, best_val and
    every weight bit for bit as two epochs in one run; the losses are
    finite and differ from the float32 run's."""
    from feta_tmlr_tpu_torch.experiments import (
        main_ZINC_graph_regression as cli)
    root = Path(__file__).resolve().parents[1]
    argv = ["--config", str(root / config), "--data-dir",
            str(root / "tests/fixtures"), "--device", "cpu"]
    rows = lambda r: [{k: v for k, v in row.items() if k != "time"}
                      for row in r["history"]]
    monkeypatch.setenv("FETA_COMPUTE_DTYPE", "bfloat16")
    ckpt = str(tmp_path / "ckpt")
    first = cli.main(argv + ["--epochs", "1", "--ckpt-dir", ckpt,
                             "--outdir", str(tmp_path / "out")])
    resumed = cli.main(argv + ["--epochs", "2", "--ckpt-dir", ckpt,
                               "--resume"])
    full = cli.main(argv + ["--epochs", "2"])
    assert rows(first) + rows(resumed) == rows(full)
    assert resumed["best_val"] == full["best_val"]
    assert all(torch.equal(resumed["state"][k], v)
               for k, v in full["state"].items())
    losses = [r["loss"] for r in full["history"]]
    assert np.isfinite(losses).all()
    monkeypatch.delenv("FETA_COMPUTE_DTYPE")
    f32 = cli.main(argv + ["--epochs", "2"])
    assert [r["loss"] for r in f32["history"]] != losses
