"""GOOM core of the PyTorch port against the JAX package: values and
gradients of to_goom / safe_log / signed_exp / goom_lse / goom_add /
scaled_exp on shared numpy inputs (JAX on the CPU, the port on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import goom as jg
from repro.core import ops as jo
from repro_torch.core import goom as tg
from repro_torch.core import ops as to
from torch_parity import n, t

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-6  # f32 elementwise maps: a few ulps apart at most


def _x(seed, shape=(4, 6), zeros=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    if zeros:
        x.flat[::5] = 0.0
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_finite_floor_matches_jax(dtype):
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64,
           torch.bfloat16: jnp.bfloat16}[dtype]
    assert np.float32(tg.finite_floor(dtype)) == np.float32(jg.finite_floor(jdt))
    assert tg.finite_floor(torch.bfloat16) == tg.finite_floor(torch.float32)


@pytest.mark.parametrize("use_floor", [False, True])
def test_to_goom_values_and_grads(use_floor):
    x = _x(0)
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def jf(xx):
        g = jg.to_goom(xx, use_floor=use_floor)
        return jnp.sum(jnp.where(jnp.isfinite(g.log_abs), g.log_abs, 0.0) * w), g

    (_, jgm), jgrad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    xt = t(x).requires_grad_()
    g = tg.to_goom(xt, use_floor=use_floor)
    la = torch.where(torch.isfinite(g.log_abs), g.log_abs, torch.zeros_like(g.log_abs))
    (la * t(w)).sum().backward()
    np.testing.assert_allclose(n(g.log_abs), n(jgm.log_abs), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(n(g.sign), n(jgm.sign))
    np.testing.assert_allclose(n(xt.grad), n(jgrad), rtol=1e-5, atol=0)


def test_to_goom_widens_bf16_and_zero_sign_is_plus_one():
    x = np.array([0.0, -0.0, -1.5, 2.0], np.float32)
    g = tg.to_goom(t(x, torch.bfloat16))
    assert g.log_abs.dtype == torch.float32
    np.testing.assert_array_equal(n(g.sign), [1.0, 1.0, -1.0, 1.0])
    jgm = jg.to_goom(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(n(g.log_abs), n(jgm.log_abs))


@pytest.mark.parametrize("use_floor", [False, True])
def test_safe_log_derivative_finite_at_zero(use_floor):
    x = np.abs(_x(2))
    jgrad = jax.grad(lambda v: jnp.sum(jg.safe_log(v, use_floor)))(jnp.asarray(x))
    xt = t(x).requires_grad_()
    tg.safe_log(xt, use_floor).sum().backward()
    assert np.all(np.isfinite(n(xt.grad)))
    np.testing.assert_allclose(n(xt.grad), n(jgrad), rtol=1e-6)
    if use_floor:
        assert float(tg.safe_log(t(x)).min()) == -np.inf
        assert float(tg.safe_log(t(x), True).min()) == np.float32(tg.LOG_ZERO)


def test_signed_exp_derivative_never_zero():
    rng = np.random.default_rng(3)
    la = rng.normal(size=(5, 3)).astype(np.float32)
    la[0, 0] = -np.inf  # exp'd to exact 0: eq. 8 still gives +eps
    sg = np.where(rng.random((5, 3)) < 0.5, -1.0, 1.0).astype(np.float32)
    jgrad = jax.grad(lambda v: jnp.sum(jg.signed_exp(v, jnp.asarray(sg))))(
        jnp.asarray(la))
    lt = t(la).requires_grad_()
    y = tg.signed_exp(lt, t(sg))
    y.sum().backward()
    np.testing.assert_allclose(n(y), n(jg.signed_exp(la, sg)), rtol=RTOL)
    np.testing.assert_allclose(n(lt.grad), n(jgrad), rtol=1e-6)
    assert np.all(n(lt.grad) != 0)


@pytest.mark.parametrize("dim", [None, 0, -1, (-2, -1)])
def test_goom_lse_values_and_grads(dim):
    rng = np.random.default_rng(4)
    la = (rng.normal(size=(3, 4, 5)) * 50).astype(np.float32)
    la[1, :, :] = -np.inf  # an all-zero slice exercises the -inf guard
    sg = np.where(rng.random(la.shape) < 0.5, -1.0, 1.0).astype(np.float32)
    jdim = dim if not isinstance(dim, tuple) else tuple(dim)

    def jf(v):
        out = jo.goom_lse(jg.Goom(v, jnp.asarray(sg)), axis=jdim)
        return jnp.sum(jnp.where(jnp.isfinite(out.log_abs), out.log_abs, 0.0)), out

    (_, jout), jgrad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(la))
    lt = t(la).requires_grad_()
    out = to.goom_lse(tg.Goom(lt, t(sg)), dim=dim)
    fin = torch.isfinite(out.log_abs)
    torch.where(fin, out.log_abs, torch.zeros_like(out.log_abs)).sum().backward()
    np.testing.assert_allclose(n(out.log_abs), n(jout.log_abs), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(n(out.sign), n(jout.sign))
    np.testing.assert_allclose(n(lt.grad), n(jgrad), rtol=1e-5, atol=1e-6)


def test_goom_add_and_mul_match_jax():
    rng = np.random.default_rng(5)
    a = [rng.normal(size=(6,)).astype(np.float32) * 30,
         np.where(rng.random(6) < 0.5, -1.0, 1.0).astype(np.float32)]
    b = [rng.normal(size=(6,)).astype(np.float32) * 30,
         np.where(rng.random(6) < 0.5, -1.0, 1.0).astype(np.float32)]
    for jfn, tfn in ((jo.goom_add, to.goom_add), (jo.goom_mul, to.goom_mul)):
        jout = jfn(jg.Goom(*map(jnp.asarray, a)), jg.Goom(*map(jnp.asarray, b)))
        tout = tfn(tg.Goom(*map(t, a)), tg.Goom(*map(t, b)))
        np.testing.assert_allclose(n(tout.log_abs), n(jout.log_abs), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(n(tout.sign), n(jout.sign))


@pytest.mark.parametrize("dim", [None, (-2, -1)])
def test_scaled_exp_values_and_grads(dim):
    rng = np.random.default_rng(6)
    la = (rng.normal(size=(2, 3, 4, 5)) * 80).astype(np.float32)
    sg = np.where(rng.random(la.shape) < 0.5, -1.0, 1.0).astype(np.float32)
    w = rng.normal(size=la.shape).astype(np.float32)

    def jf(v):
        vals, scale = jo.scaled_exp(jg.Goom(v, jnp.asarray(sg)), axis=dim, shift=2.0)
        return jnp.sum(vals * w), (vals, scale)

    (_, (jv, js)), jgrad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(la))
    lt = t(la).requires_grad_()
    vals, scale = to.scaled_exp(tg.Goom(lt, t(sg)), dim=dim, shift=2.0)
    (vals * t(w)).sum().backward()
    np.testing.assert_allclose(n(vals), n(jv), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(n(scale), n(js), rtol=1e-6)
    np.testing.assert_allclose(n(lt.grad), n(jgrad), rtol=1e-5, atol=1e-6)


def test_goom_zeros_and_ones():
    z = tg.goom_zeros((2, 3), device="cpu")
    assert torch.all(z.log_abs == -np.inf) and torch.all(z.sign == 1)
    zf = tg.goom_zeros((2, 3), device="cpu", use_floor=True)
    assert torch.all(zf.log_abs == np.float32(jg.LOG_ZERO))
    o = tg.goom_ones((2,), device="cpu")
    np.testing.assert_array_equal(n(tg.from_goom(o)), [1.0, 1.0])
