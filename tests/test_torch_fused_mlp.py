"""The port's fused-MLP wrapper vs the JAX package, on the CPU.

On the CPU `fused_mlp_fwd` / `fused_mlp_bwd` take their plain versions
(CPU tensors); those are held to the JAX `fused_mlp` with its Pallas
kernels run in interpret mode, as tests/test_fused_mlp.py runs them, and to
its jnp twin `fused_mlp_ref`, forward and gradients at rate 0. The TPU
kernel's dropout bits come from the TPU PRNG and cannot be reproduced, so
at rate > 0 the port is held to the invariants instead: deterministic per
seed, a different mask for another seed, the keep fraction, and a backward
that regenerates the forward's mask. The CUDA kernels are held to the plain
versions by tests/test_torch_cuda.py and chip_smoke.py on the card.

Tolerances (f32, sums in another order on the two sides): forward rtol
1e-5 / atol 1e-5; gradients rtol 2e-4 / atol 2e-4 (reductions over 70 rows
and 256 hidden units, as tests/test_fused_mlp.py holds the JAX kernel to
its twin).
"""

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from feta_tmlr_tpu.ops.pallas import fused_mlp as jfm
from feta_tmlr_tpu_torch.ops.kernels import fused_mlp as tfm

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(jfm.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))


def _inputs(seed=0, r=70, din=8, f=256, dout=8):
    rng = np.random.default_rng(seed)
    t = lambda *s: rng.standard_normal(s).astype(np.float32)
    return t(r, din), t(din, f), t(f), t(f, dout), t(dout)


def _torch(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("shape", [(70, 8, 256, 8), (33, 3, 100, 5)])
def test_forward_matches_jax_kernel_and_twin(interpret_mode, shape):
    r, din, f, dout = shape
    arrays = _inputs(r=r, din=din, f=f, dout=dout)
    j = [jnp.asarray(a) for a in arrays]
    got = tfm.fused_mlp_fwd(*_torch(arrays)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jfm.fused_mlp(*j, block_rows=32)), **FWD_TOL)
    np.testing.assert_allclose(got, np.asarray(jfm.fused_mlp_ref(*j)),
                               **FWD_TOL)
    assert tfm.fused_mlp_fwd.launches == 0       # CPU: the plain version


def test_grads_match_jax_kernel_and_twin(interpret_mode):
    arrays = _inputs()
    co = np.random.default_rng(1).standard_normal((70, 8)).astype(np.float32)

    def jgrads(fn):
        loss = lambda *a: (fn(*a) * jnp.asarray(co)).sum()
        return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            *[jnp.asarray(a) for a in arrays])

    ts = _torch(arrays, grad=True)
    (tfm.fused_mlp(*ts) * torch.from_numpy(co)).sum().backward()
    want_kernel = jgrads(lambda *a: jfm.fused_mlp(*a, block_rows=32))
    want_twin = jgrads(jfm.fused_mlp_ref)
    for t, wk, wt in zip(ts, want_kernel, want_twin):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wk),
                                   **GRAD_TOL)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wt),
                                   **GRAD_TOL)
    assert tfm.fused_mlp_bwd.launches == 0


def test_backward_wrapper_matches_autograd_of_plain():
    """The plain backward (what the CUDA backward kernels compute) vs
    autograd through the plain forward, at rate 0 and at rate 0.3: equal
    gradients at rate 0.3 need the backward's mask to be the forward's."""
    arrays = _inputs(seed=2, r=40, f=128)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (40, 8)).astype(np.float32))
    for rate, seed in ((0.0, None), (0.3, 11)):
        ts = _torch(arrays, grad=True)
        (tfm.fused_mlp_plain(*ts, rate, seed) * g).sum().backward()
        x, w1, b1, w2, _ = _torch(arrays)
        got = tfm.fused_mlp_bwd(x, w1, b1, w2, g, rate, seed)
        for t, gg in zip(ts, got):
            np.testing.assert_allclose(gg.numpy(), t.grad.numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_dropout_deterministic_per_seed():
    args = _torch(_inputs())
    y1 = tfm.fused_mlp(*args, dropout_rate=0.4, seed=7)
    y2 = tfm.fused_mlp(*args, dropout_rate=0.4, seed=7)
    y3 = tfm.fused_mlp(*args, dropout_rate=0.4, seed=8)
    assert torch.equal(y1, y2)
    assert not torch.allclose(y1, y3)
    with pytest.raises(ValueError, match="requires a seed"):
        tfm.fused_mlp(*args, dropout_rate=0.4)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_fraction_and_independence(rate):
    """Over 2^20 draws the keep fraction is 1 - rate within 5 standard
    deviations (<= 2.5e-3); rows and units are not correlated: two
    neighbouring rows agree as often as independent draws would."""
    keep = tfm.dropout_keep(5, 512, 2048, rate)
    p = 1.0 - rate
    frac = float(keep.float().mean())
    assert abs(frac - p) < 5 * np.sqrt(p * (1 - p) / keep.numel())
    same = float((keep[1:] == keep[:-1]).float().mean())
    assert abs(same - (p * p + (1 - p) ** 2)) < 0.01
    assert not torch.equal(keep, tfm.dropout_keep(6, 512, 2048, rate))


def test_dropout_mask_matches_integer_reference():
    """The tensor hash is the 32-bit mixer of csrc/fused_mlp.cu, checked
    against Python integers (no int64 overflow in the 16-bit-half
    products)."""
    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    seed, rate = 12345, 0.1
    keep = tfm.dropout_keep(seed, 7, 300, rate)
    key = mix(seed ^ 0x9E3779B9)
    want = [[mix(mix(key ^ r) ^ j) < tfm.keep_threshold(rate)
             for j in range(300)] for r in range(7)]
    assert keep.tolist() == want
    xs = np.random.default_rng(4).integers(0, 2 ** 32, 1000)
    got = tfm.mix32(torch.from_numpy(xs.astype(np.int64))).tolist()
    assert got == [mix(int(x)) for x in xs]


def test_dropout_backward_matches_finite_difference():
    """Directional finite difference of the loss (float64) == the fused
    VJP along the same seed."""
    arrays = [a.astype(np.float64) for a in _inputs(r=40, f=128)]
    x, w1, b1, w2, b2 = _torch(arrays)
    f = lambda xx: (tfm.fused_mlp(xx, w1, b1, w2, b2, dropout_rate=0.3,
                                  seed=3) ** 2).sum()
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(x.shape))
    eps = 1e-6
    fd = (f(x + eps * v) - f(x - eps * v)) / (2 * eps)
    xg = x.clone().requires_grad_()
    f(xg).backward()
    np.testing.assert_allclose(float(fd), float((xg.grad * v).sum()),
                               rtol=1e-6)


def test_wrappers_reject_other_devices():
    x = torch.zeros(4, 8, device="meta")
    w1, b1, w2, b2 = (torch.zeros(s, device="meta")
                      for s in ((8, 16), (16,), (16, 8), (8,)))
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.fused_mlp_fwd(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="outside"):
        tfm.fused_mlp_plain(*_torch(_inputs()), 1.0, 1)
