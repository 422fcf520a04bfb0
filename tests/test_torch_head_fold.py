"""The port's "fold" and "r4" attention settings vs the JAX package's
FETA_FLASH_HEAD_FOLD=1 and FETA_FLASH_NEED_HEADS=0 routes, on the CPU.

"fold" is the port's `head_fold=True`: every flash call, forward and
backward, through the head-folded kernels (`csrc/flash_hf.cu`; the TPU's
`_fwd_kernel_hf`, `_bwd_q_kernel_hf` and `_bwd_k_kernel_hf`). "r4" is
`flash_need_heads=False`: the filtered layer through the score product
and the modulation kernel, the other layers through the unfolded flash
kernels. The JAX side runs its Pallas kernels in interpret mode with the
accelerator check forced true (as tests/test_torch_layers.py does) and the
environment switch set; spies on its `_call_*_hf` entry points show that
the folded kernels ran there, spies on the port's wrappers that the port
routed through their folded twins. On CPU tensors the wrappers run their
plain versions, and their launch counters stay at 0 (they count kernel
launches only).

Tolerances (f32, sums in other orders on the two sides):
  attention outputs             rtol 1e-4 / atol 1e-5, as
      tests/test_flash_attention.py; their gradients rtol 1e-4 / atol 2e-5
      (one more f32 reduction over the keys), as tests/test_torch_kernels.py;
  one layer                     rtol 2e-4 / atol 2e-5 forward, rtol 1e-3 /
      atol 1e-5 gradients, as tests/test_torch_layers.py;
  model forward                 rtol 5e-4 / atol 5e-5, as
      tests/test_torch_model.py;
  one Trainer step              loss and gradients rtol 1e-3 / atol 1e-5,
      batch-norm statistics rtol 1e-4 / atol 1e-5, as
      tests/test_torch_train.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import feta_tmlr_tpu.config as jcfg
from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.data.synthetic import sbm_like_dataset as j_sbm
from feta_tmlr_tpu.nn import layers as jlayers
from feta_tmlr_tpu.nn import models as jmodels
from feta_tmlr_tpu.ops.pallas import flash_attention as jfl
from feta_tmlr_tpu.pe import encodings as jpe
from feta_tmlr_tpu.train.trainer import TrainConfig as JTrainConfig
from feta_tmlr_tpu.train.trainer import Trainer as JTrainer
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.data.synthetic import sbm_like_dataset as t_sbm
from feta_tmlr_tpu_torch.nn import layers as tlayers
from feta_tmlr_tpu_torch.nn import models as tmodels
from feta_tmlr_tpu_torch.ops.kernels import colstat as tcs
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as tfl
from feta_tmlr_tpu_torch.ops.kernels import modulation as tmod
from feta_tmlr_tpu_torch.ops.kernels.common import bwd_row_constants
from feta_tmlr_tpu_torch.pe import encodings as tpe
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
LAYER_TOL = dict(rtol=2e-4, atol=2e-5)
LAYER_GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
MODEL_TOL = dict(rtol=5e-4, atol=5e-5)
STEP_TOL = dict(rtol=1e-3, atol=1e-5)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
CFG = dict(in_size=3, nb_class=2, d_model=16, nb_heads=2, dim_feedforward=32,
           dropout=0.0, nb_layers=2, batch_norm=True, lap_pos_enc=True,
           lap_pos_enc_dim=4, filter_order=3)
N_MAX = 32
# setting: (JAX environment, port options)
SETTINGS = {
    "fold": ({"FETA_FLASH_HEAD_FOLD": "1", "FETA_FLASH_NEED_HEADS": "1"},
             dict(head_fold=True, flash_need_heads=True)),
    "r4": ({"FETA_FLASH_HEAD_FOLD": "0", "FETA_FLASH_NEED_HEADS": "0"},
           dict(head_fold=False, flash_need_heads=False)),
}
# the port's wrappers whose calls the spies count
WRAPPED = ((tfl, "flash_fwd"), (tfl, "flash_bwd_q"), (tfl, "flash_bwd_k"),
           (tfl, "flash_fwd_hf"), (tfl, "flash_bwd_q_hf"),
           (tfl, "flash_bwd_k_hf"), (tcs, "colstat"),
           (tmod, "modulation_fwd"), (tmod, "modulation_bwd"))


@pytest.fixture
def jax_setting(monkeypatch, request):
    """The JAX package on its Pallas flash route, interpreted, under the
    setting `request.param`; returns (setting name, JAX folded-kernel call
    counts)."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    monkeypatch.setenv("FETA_PALLAS", "1")
    monkeypatch.setenv("FETA_PALLAS_IMPL", "flash")
    for key, value in SETTINGS[request.param][0].items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(jcfg, "_on_accelerator", lambda: True)
    monkeypatch.setattr(jcfg, "PALLAS_AUTO_N", 0)
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("_call_fwd_hf", "fwd"), ("_call_bwd_hf", "bwd")):
        def spy(*a, _fn=getattr(jfl, name), _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(jfl, name, spy)
    return request.param, calls


@pytest.fixture
def port_calls(monkeypatch):
    """Calls of the port's kernel wrappers, by name."""
    calls = dict.fromkeys((name for _, name in WRAPPED), 0)
    for mod, name in WRAPPED:
        def spy(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return calls


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- kernels

def _inputs(seed, dv, case, b=2, h=2, n=32, d=8, pad=5):
    """Attention operands, graph 0 padded by `pad` nodes; in the guard case
    pe is zero on the first 6 query rows of graph 1, so those rows take the
    |su/se| <= 1e-9 branch of forward and backward."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[0, n - pad:] = False
    pe = (rng.random((b, n, n)) * mask[:, :, None]
          * mask[:, None, :]).astype(np.float32)
    if case == "guard":
        pe[1, :6] = 0.0
    deg = (rng.random((b, n)) * mask).astype(np.float32)
    diff = (f(b, h, n, d), f(b, n, d), f(b, n, h), f(b, n, h), f(h),
            f(b, h, n, dv))
    mod = dict(pe=pe, degree=deg) if case != "plain" else {}
    return diff, mask, mod


# both value widths with pe/degree; the cases without them and with guard
# rows take the other branches of the same code at any width
@pytest.mark.parametrize("dv, case", [(8, "mod"), (64, "mod"), (8, "plain"),
                                      (8, "guard")])
@pytest.mark.parametrize("heads", [False, True])
@pytest.mark.parametrize("jax_setting", ["fold"], indirect=True)
def test_folded_attention_and_grads_match_jax(heads, dv, case, jax_setting,
                                              port_calls):
    """Both public entry points with the folds on, outputs and gradients
    of every differentiable input: JAX's `_hf` kernels interpreted over
    4 x 4 tiles of 8 (n=32), the port's folded wrappers on CPU tensors."""
    _, jcalls = jax_setting
    diff, mask, mod = _inputs(20 + dv, dv, case)
    b, h, n, _ = diff[0].shape
    g = np.random.default_rng(21).standard_normal(
        (b, n, h, dv) if heads else (b, n, dv)).astype(np.float32)
    jmod = {k: jnp.asarray(v) for k, v in mod.items()}

    def jcall(*args):
        if heads:
            return jfl.flash_graphit_attention_heads(
                *args, jnp.asarray(mask), block_q=8, block_k=8, **jmod)
        return jfl.flash_graphit_attention(
            *args, jnp.asarray(mask), block_q=8, block_k=8, **jmod)

    want, vjp = jax.vjp(jcall, *(jnp.asarray(a) for a in diff))
    cot = (jnp.asarray(g), jnp.zeros_like(want[1])) if heads else g
    want_grads = vjp(cot)                       # s is detached: no cotangent
    assert jcalls["fwd"] == 1 and jcalls["bwd"] == 1

    tdiff = [_t(a).requires_grad_() for a in diff]
    tmask = {k: _t(v) for k, v in mod.items()}
    if heads:
        got, s = tfl.flash_graphit_attention_heads(
            *tdiff, _t(mask), head_fold=True, **tmask)
        np.testing.assert_allclose(s.numpy(), np.asarray(want[1]), **TOL)
        want = want[0]
    else:
        got = tfl.flash_graphit_attention(*tdiff, _t(mask), head_fold=True,
                                          **tmask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    (got * _t(g)).sum().backward()
    for name, t, w in zip(("xa", "x", "cq", "ck", "c0", "vw"), tdiff,
                          want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)
    assert port_calls["flash_fwd_hf"] == 1
    assert port_calls["flash_bwd_q_hf"] == port_calls["flash_bwd_k_hf"] == 1
    assert port_calls["flash_fwd"] == port_calls["flash_bwd_q"] == \
        port_calls["flash_bwd_k"] == 0
    assert port_calls["colstat"] == (2 if heads else 0)


def test_folded_wrappers_are_the_plain_functions_on_the_cpu():
    """On CPU tensors a folded wrapper returns exactly its unfolded twin's
    plain result (the same function) and counts no launch, and it raises
    as the unfolded one does on a device it does not take."""
    folded = (tfl.flash_fwd_hf, tfl.flash_bwd_q_hf, tfl.flash_bwd_k_hf)
    before = [fn.launches for fn in folded]
    diff, mask, mod = _inputs(30, 8, "guard")
    ops = tfl.prepare(*(_t(a) for a in diff[:5]), _t(mask), _t(mod["pe"]),
                      _t(mod["degree"]))
    vw = _t(diff[5])
    fwd = tfl.flash_fwd_hf(vw=vw, **ops)
    for got, want in zip(fwd, tfl.flash_fwd(vw=vw, **ops)):
        assert torch.equal(got, want)
    outh, m, se, su = fwd
    g = torch.ones_like(outh)
    args = (ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"], vw,
            ops["pe"], ops["deg"], ops["mask"], ops["inv_sqrt"], g, m,
            *bwd_row_constants(g, outh, se, su, ops["mask"]))
    for got, want in zip(tfl.flash_bwd(*args, head_fold=True),
                         tfl.flash_bwd(*args)):
        assert torch.equal(got, want)
    assert [fn.launches for fn in folded] == before
    with pytest.raises(ValueError, match="unsupported device"):
        tfl.flash_bwd_k_hf(*(t.to("meta") if torch.is_tensor(t) else t
                             for t in args))


# ------------------------------------------------------------------ layer

def _layer_inputs(seed=40, b=2, n=32, d=16, pad=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[0, n - pad:] = False
    pe = (rng.random((b, n, n)) * mask[:, :, None]
          * mask[:, None, :]).astype(np.float32)
    deg = (rng.random((b, n)) * mask).astype(np.float32)
    return x, mask, pe, deg


@pytest.mark.parametrize("need_heads", [False, True])
@pytest.mark.parametrize("jax_setting", ["fold", "r4"], indirect=True)
def test_layer_matches_jax(jax_setting, need_heads, port_calls):
    """One train-mode GraphiT layer (batch norm on its batch statistics):
    the output and per-head outputs, then the gradients w.r.t. every
    parameter and the input, against the JAX layer under the same
    setting."""
    setting, jcalls = jax_setting
    x, mask, pe, deg = _layer_inputs()
    rng = np.random.default_rng(41)
    layer = jlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True)
    jx, jpe_, jmask, jdeg = (jnp.asarray(a) for a in (x, pe, mask, deg))
    variables = dict(layer.init(jax.random.key(0), jx, jpe_, jmask, jdeg))
    variables["params"] = jax.tree.map(       # non-zero biases
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        variables["params"])
    g_out = rng.standard_normal(x.shape).astype(np.float32)
    g_heads = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)

    def jforward(params, xin):
        (out, _, heads), _ = layer.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            xin, jpe_, jmask, jdeg, deterministic=False,
            need_heads=need_heads, mutable=["batch_stats"])
        return out, heads

    def jloss(params, xin):
        out, heads = jforward(params, xin)
        loss = (out * g_out).sum()
        return loss + (heads * g_heads).sum() if need_heads else loss

    w_out, w_heads = jforward(variables["params"], jx)
    w_params, w_x = jax.grad(jloss, argnums=(0, 1))(variables["params"], jx)
    folded = setting == "fold"
    assert (jcalls["fwd"] > 0, jcalls["bwd"] > 0) == (folded, folded)

    port = from_flax(_np(variables), tlayers.GraphiTEncoderLayer(
        16, 2, 32, 0.0, True, **SETTINGS[setting][1]))
    port.train()
    tx = _t(x).requires_grad_()
    out, attn, heads = port(tx, _t(pe), _t(mask), _t(deg),
                            need_heads=need_heads)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(w_out),
                               **LAYER_TOL)
    loss = (out * _t(g_out)).sum()
    if need_heads:
        np.testing.assert_allclose(heads.detach().numpy(),
                                   np.asarray(w_heads), **LAYER_TOL)
        assert isinstance(attn, tlayers.AttnColStats) == folded
        loss = loss + (heads * _t(g_heads)).sum()
    loss.backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(w_x),
                               **LAYER_GRAD_TOL)
    want = from_flax({"params": _np(w_params),
                      "batch_stats": _np(variables["batch_stats"])},
                     tlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True))
    want = dict(want.named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[name].detach().numpy(),
                                   err_msg=name, **LAYER_GRAD_TOL)
    dense = setting == "r4" and need_heads
    assert port_calls["modulation_fwd"] == port_calls["modulation_bwd"] == \
        int(dense)
    assert port_calls["flash_fwd_hf"] == int(folded)
    assert port_calls["flash_fwd"] == int(not folded and not dense)


# ------------------------------------------------------------------ model

def _batches(seed=8, per=2, n=N_MAX, lap_dim=4):
    """Two batches of `per` SBM graphs each, JAX and port collations."""
    jg = j_sbm(seed=seed, n_graphs=2 * per, n_nodes=n)
    tg = t_sbm(seed=seed, n_graphs=2 * per, n_nodes=n)
    for enc in (jpe.DiffusionEncoding(beta=1.0), jpe.LapEncoding(lap_dim)):
        enc.apply_to(jg)
    for enc in (tpe.DiffusionEncoding(beta=1.0), tpe.LapEncoding(lap_dim)):
        enc.apply_to(tg)
    kw = dict(max_nodes=n, node_labels=True)
    return ([jbatch.collate_graphs(jg[i:i + per], **kw) for i in (0, per)],
            [tbatch.collate_graphs(tg[i:i + per], **kw) for i in (0, per)])


def _port_from(params, batch_stats, setting):
    model = tmodels.DiffGraphTransformerGenGCNSBM(
        **CFG, **SETTINGS[setting][1], device="cpu")
    return from_flax({"params": _np(params), "batch_stats": _np(batch_stats)},
                     model)


def _perturbed_trainer(jbatch0):
    """The JAX trainer and its initial state with non-zero biases."""
    jtr = JTrainer(jmodels.DiffGraphTransformerGenGCNSBM(**CFG),
                   JTrainConfig(task="node_clf", lr=1e-3, weight_decay=1e-5,
                                regularization=0.1, sign_flip=False))
    state = jtr.init(jax.random.key(0), jbatch0)
    rng = np.random.default_rng(13)
    params = jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        state.params)
    return jtr, state.replace(params=params,
                              opt_state=jtr.optimizer.init(params))


# the port's wrapper calls in one training step of the 2-layer model: the
# unfiltered layer and the filtered one
STEP_CALLS = {
    "fold": {"flash_fwd_hf": 2, "flash_bwd_q_hf": 2, "flash_bwd_k_hf": 2,
             "colstat": 2},
    "r4": {"flash_fwd": 1, "flash_bwd_q": 1, "flash_bwd_k": 1,
           "modulation_fwd": 1, "modulation_bwd": 1},
}


@pytest.mark.parametrize("jax_setting", ["fold", "r4"], indirect=True)
def test_model_forward_and_trainer_step_match_jax(jax_setting, port_calls):
    """The small SBM model's eval forward on two batches, then one Trainer
    step (AdamW, dropout 0, sign flip off): loss, every gradient and the
    updated batch-norm statistics, against the JAX trainer under the same
    setting. The port's wrapper calls in the step are exact."""
    setting, jcalls = jax_setting
    jbs, tbs = _batches()
    jtr, state = _perturbed_trainer(jbs[0])
    port = _port_from(state.params["params"], state.batch_stats, setting)
    port.eval()
    with torch.inference_mode():
        for jb, tb in zip(jbs, tbs):
            want, _ = jtr.model.apply(
                {"params": state.params["params"],
                 "batch_stats": state.batch_stats}, jb)
            got, _ = port(tb)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **MODEL_TOL)
    assert (jcalls["fwd"] > 0) == (setting == "fold")

    _, jgrads, _ = jtr._loss_and_grads(state.params, state.batch_stats,
                                       jbs[0], jax.random.key(1))
    state, jloss = jtr._jit_step(state, jbs[0], jax.random.key(1))
    trainer = Trainer(port, TrainConfig(lr=1e-3, weight_decay=1e-5,
                                        regularization=0.1, sign_flip=False))
    for name in port_calls:
        port_calls[name] = 0
    tloss = trainer.step(tbs[0])
    assert port_calls == {**dict.fromkeys(port_calls, 0),
                          **STEP_CALLS[setting]}
    np.testing.assert_allclose(float(tloss), float(jloss), **STEP_TOL)
    want = dict(_port_from(jgrads["params"], state.batch_stats,
                           setting).named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[name].detach().numpy(),
                                   err_msg=name, **STEP_TOL)
    after = dict(_port_from(state.params["params"], state.batch_stats,
                            setting).named_buffers())
    for name, buf in port.named_buffers():
        np.testing.assert_allclose(buf.numpy(), after[name].numpy(),
                                   err_msg=name, **STATS_TOL)


def test_options_reach_every_layer_and_change_nothing_off_flash():
    """`head_fold` and `flash_need_heads` reach every layer of the model;
    under "modulation" (as under JAX's FETA_PALLAS_IMPL=modulation, where
    the switches are not read) the model computes what it computes
    without them."""
    model = tmodels.DiffGraphTransformerGenGCNSBM(
        **CFG, head_fold=True, flash_need_heads=False, device="cpu")
    assert all(layer.head_fold and not layer.flash_need_heads
               for layer in model.encoder.layers)
    _, tbs = _batches(seed=9)
    plain = tmodels.DiffGraphTransformerGenGCNSBM(
        **CFG, attention_impl="modulation", device="cpu")
    refined = tmodels.DiffGraphTransformerGenGCNSBM(
        **CFG, attention_impl="modulation", head_fold=True,
        flash_need_heads=False, device="cpu")
    with torch.inference_mode():
        assert torch.equal(plain.eval()(tbs[0])[0],
                           refined.eval()(tbs[0])[0])
