"""The flagship ZINC regressor (`DiffGraphTransformerGenGCN`) under the
bf16 compute policy, the port against the JAX package on the CPU with one
torch thread: logits and one Trainer step on the "flash" route, JAX's
kernels interpreted (tests/test_torch_mixed_precision.py's `bf16_flash`), weights
through `convert.from_flax`, inputs from `zinc_like_dataset`.

Tolerances, as tests/test_torch_mixed_precision.py: logits, regularizer
and loss rtol 1e-2 / atol 1e-2; each gradient entry within 1e-2 of the
step's largest gradient entry: through two bf16 layers a rounding flips
with the rounding of the layer before (a ReLU gate next to zero, a P or
ds next to a rounding edge), and its noise scales with the activations
and cotangents it rounds, not with each parameter's own gradient (a small
one, as the last layer's, or a sum over rows that cancels, as a bias's,
reads up to 1e-1 of its own largest entry); the biases JAX adds in bf16
are held through their cotangents (`check_bf16_biases`: the port's to
its rows' float32 sum rounded once, JAX's within the error bound of its
row-by-row bf16 sum).
"""

import functools

import numpy as np
import pytest
import torch

import jax

from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.nn import models as jmodels
from feta_tmlr_tpu.train.trainer import TrainConfig as JTrainConfig
from feta_tmlr_tpu.train.trainer import Trainer as JTrainer
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.nn import models as tmodels
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
from test_torch_mixed_precision import (  # noqa: F401 (fixtures)
    OUT_TOL,
    _grad_close,
    _np,
    bf16_cotangents,
    bf16_flash,
    check_bf16_biases,
    one_thread,
)
from test_torch_zinc import CFG, N_MAX, _graphs, _perturb

TRAIN = dict(task="graph_reg", lr=1e-3, weight_decay=1e-5,
             regularization=0.1, sign_flip=False)


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """Three ZINC graphs on both sides and the JAX Trainer's initial
    variables, perturbed (non-zero biases, running statistics): shared by
    the tests (the JAX init is compiled once)."""
    jg, tg = _graphs(seed=5, n_graphs=3)
    jb = jbatch.collate_graphs(jg, max_nodes=N_MAX)
    jtr = JTrainer(jmodels.DiffGraphTransformerGenGCN(**CFG),
                   JTrainConfig(**TRAIN))
    state = jtr.init(jax.random.key(0), jb)
    variables = _perturb({"params": state.params["params"],
                          "batch_stats": state.batch_stats},
                         np.random.default_rng(13))
    return jtr, jb, tbatch.collate_graphs(tg, max_nodes=N_MAX), variables


def _port(variables):
    return from_flax(_np(variables), tmodels.DiffGraphTransformerGenGCN(
        **CFG, attention_impl="flash", device="cpu"))


def _logits(variables, jb, tb, monkeypatch):
    """The JAX model's and the port's eval logits and regularizer under
    the policy; the port's logits with the policy off as well."""
    jmodel = jmodels.DiffGraphTransformerGenGCN(**CFG)
    want, want_reg = jax.jit(functools.partial(
        jmodel.apply, regularization=0.1))(variables, jb)
    port = _port(variables).eval()
    with torch.inference_mode():
        got, reg = port(tb, regularization=0.1)
        monkeypatch.delenv("FETA_COMPUTE_DTYPE")
        got32, _ = port(tb, regularization=0.1)
        monkeypatch.setenv("FETA_COMPUTE_DTYPE", "bfloat16")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    np.testing.assert_allclose(float(reg), float(want_reg), **OUT_TOL)
    assert not torch.equal(got, got32)         # the policy is on


@pytest.mark.parametrize("bf16_flash", ["1", "0"], indirect=True)
def test_bf16_zinc_logits_and_trainer_step_match_jax(bf16_flash,
                                                     monkeypatch,
                                                     bf16_cotangents):
    """On the "flash" route with pe/deg in bf16 ("1") and in float32
    ("0"): the logits and regularizer (OUT_TOL), then one Trainer step
    (L1, regularizer 0.1, sign flip off) against the JAX Trainer's
    `_loss_and_grads`: the loss (OUT_TOL) and every parameter's gradient
    (GRAD_REL of the step's largest entry; the bf16 biases by
    `check_bf16_biases`); parameters, gradients and the AdamW state stay
    float32."""
    jtr, jb, tb, variables = _jax_setup()
    _logits(variables, jb, tb, monkeypatch)
    jloss, jgrads, _ = jax.jit(jtr._loss_and_grads)(
        {"params": variables["params"]}, variables["batch_stats"], jb,
        jax.random.key(1))
    port = _port(variables)
    trainer = Trainer(port, TrainConfig(**TRAIN))
    loss = trainer.step(tb)
    np.testing.assert_allclose(float(loss), float(jloss), **OUT_TOL)
    want = dict(_port({"params": jgrads["params"],
                       "batch_stats": variables["batch_stats"]})
                .named_parameters())
    scale = max(float(w.detach().abs().max()) for w in want.values())
    biases = check_bf16_biases(port, want, bf16_cotangents, emulate=False,
                               scale=scale)
    assert "encoder.cheb_bias" in biases
    for name, p in port.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        if name not in biases:
            _grad_close(p.grad.numpy(), want[name].detach().numpy(), name,
                        scale)
    assert all(t.dtype == torch.float32 for s in trainer.optimizer.state.values()
               for t in s.values() if torch.is_tensor(t))
