"""The port's diagonal GOOM scan against the JAX package, on the CPU.

``engine.diagonal_scan`` (the plain version on CPU planes) is held to JAX's
``core.scan.diagonal_scan`` and to the TPU Pallas kernel
(``goom_scan_pallas(..., variant="tpu", interpret=True)``, as the JAX tests
run it) on e±200 signed inputs, exact zeros, exact cancellation, T=1, odd
shapes and a broadcast ``a``; the carry form chunked against one full scan;
gradients against JAX's; and the CUDA wrapper's plain path and stride
handling.  Tolerance: values over each entry's scale within 1e-4
(``assert_goom_close``), and away from cancellation logs within 2e-4 and
signs equal.

Inputs are made with numpy from a seed and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jax_engine
from repro.core import scan as jax_scan
from repro.core.goom import Goom as JGoom
from repro.kernels.goom_scan.ops import goom_scan_pallas
from repro_torch.core import engine
from repro_torch.core.goom import Goom
from repro_torch.kernels.goom_scan import diagonal_scan_cuda, goom_diag_scan_ref
from repro_torch.kernels.goom_scan import ops as scan_ops
from torch_parity import assert_goom_close, n, t

torch.set_num_threads(2)


def _planes(rng, shape, *, spread=200.0, decay=False):
    """(log, sign) f32 planes: logs N(0, 1) shifted by U(-spread, spread) per
    entry, random signs; ``decay`` gives Mamba's decays instead (log <= 0,
    sign +1)."""
    if decay:
        return (-np.abs(rng.normal(size=shape))).astype(np.float32), np.ones(shape, np.float32)
    log = rng.normal(size=shape) + rng.uniform(-spread, spread, size=shape)
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    return log.astype(np.float32), sign.astype(np.float32)


def _inputs(tlen, trail, seed, *, a_trail=None, spread=200.0, decay=False):
    rng = np.random.default_rng(seed)
    a = _planes(rng, (tlen,) + tuple(a_trail or trail), spread=0.5, decay=decay)
    b = _planes(rng, (tlen,) + tuple(trail), spread=spread)
    x0 = _planes(rng, tuple(trail), spread=spread)
    return a, b, x0


def _port(planes) -> Goom:
    return Goom(t(planes[0]), t(planes[1]))


def _jax(planes) -> JGoom:
    return JGoom(jnp.asarray(planes[0]), jnp.asarray(planes[1]))


def _jax_scan(a, b, x0):
    """JAX's ``engine.diagonal_scan`` under its reference backend, jitted."""
    def f(a, b, x0):
        with jax_engine.use_backend("xla_reference"):
            return jax_engine.diagonal_scan(a, b, x0)

    return jax.jit(f)(_jax(a), _jax(b), None if x0 is None else _jax(x0))


def _scale(a, b, x0) -> np.ndarray:
    """Each state's size before its terms cancel: the scan of |values|."""
    ones = lambda p: (p[0], np.ones_like(p[1]))  # noqa: E731
    s = goom_diag_scan_ref(_port(ones(a)), _port(ones(b)),
                           None if x0 is None else _port(ones(x0)))
    return n(s.log_abs)


def _close(got, want, scale, margin=8.0):
    assert_goom_close(got.log_abs, got.sign, want.log_abs, want.sign,
                      scale_log=scale, cancel_margin=margin)
    gl, wl, ws = n(got.log_abs), n(want.log_abs), n(want.sign)
    ok = wl > np.where(np.isfinite(scale), scale, 0.0) - margin
    np.testing.assert_allclose(gl[ok], wl[ok], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(n(got.sign)[ok], ws[ok])


# name: (T, trailing shape, a's trailing shape or None)
CASES = {
    "e200_signed": (64, (4, 16), None),
    "t1": (1, (33,), None),
    "odd": (13, (3, 5), None),
    "odd_long": (129, (7,), None),
    "broadcast_a": (9, (2, 3, 5), (1, 3, 5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_diagonal_scan_matches_jax_e200(case):
    tlen, trail, a_trail = CASES[case]
    a, b, x0 = _inputs(tlen, trail, seed=len(case), a_trail=a_trail)
    before = diagonal_scan_cuda.launches
    engine.reset_calls()
    got = engine.diagonal_scan(_port(a), _port(b), _port(x0))
    assert engine.calls["diagonal_scan"] == 1
    assert diagonal_scan_cuda.launches == before  # the CPU never launches
    want = _jax_scan(a, b, x0)
    assert tuple(got.shape) == (tlen,) + trail
    a_full = tuple(np.broadcast_to(p, (tlen,) + trail) for p in a)
    _close(got, want, _scale(a_full, b, x0))


@pytest.mark.parametrize("tlen,c", [(8, 8), (37, 5), (1, 12), (64, 16)])
def test_diagonal_scan_matches_the_pallas_tpu_kernel(tlen, c):
    """The TPU kernel (interpret mode) on Mamba-like decays and e±200
    inputs; it brackets per time tile and folds a carry, the port as JAX's
    ``associative_scan``, so the two agree to rounding."""
    a, b, x0 = _inputs(tlen, (c,), seed=tlen * c, decay=True)
    want = goom_scan_pallas(_jax(a), _jax(b), _jax(x0), variant="tpu", interpret=True,
                            block_t=8, block_c=8)
    got = engine.diagonal_scan(_port(a), _port(b), _port(x0))
    _close(got, want, _scale(a, b, x0))


def test_exact_zeros_and_cancellation_give_minus_inf_plus_one():
    """Zero inputs stay exact zeros; a state that cancels exactly is
    (-inf, +1), and the next state is then the next input alone."""
    tlen, c = 4, 6
    a = (np.zeros((tlen, c), np.float32), np.ones((tlen, c), np.float32))
    b_log = np.full((tlen, c), -np.inf, np.float32)
    b_sign = np.ones((tlen, c), np.float32)
    # channels 0-2: x0 = 1, a = 1, b_0 = -1 → x_0 = 0 exactly
    b_sign[0, :3] = -1.0
    b_log[0, :3] = 0.0
    # then b_1 = 2.5 in channel 0
    b_log[1, 0] = np.log(2.5)
    x0 = (np.where(np.arange(c) < 3, 0.0, -np.inf).astype(np.float32),
          np.ones(c, np.float32))
    b = (b_log, b_sign)
    for got in (engine.diagonal_scan(_port(a), _port(b), _port(x0)),
                _jax_scan(a, b, x0),
                goom_scan_pallas(_jax(a), _jax(b), _jax(x0), variant="tpu",
                                 interpret=True, block_t=8, block_c=8)):
        gl, gs = n(got.log_abs), n(got.sign)
        assert np.all(np.isneginf(gl[0])) and np.all(gs[0] == 1.0)
        np.testing.assert_allclose(gl[1:, 0], np.log(2.5), rtol=1e-5)
        assert np.all(np.isneginf(gl[:, 1:])) and np.all(gs == 1.0)


def test_no_x0_starts_from_zero():
    a, b, _ = _inputs(11, (4,), seed=3)
    got = engine.diagonal_scan(_port(a), _port(b))
    want = _jax_scan(a, b, None)
    _close(got, want, _scale(a, b, None))


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_carry_chunked_matches_full_e200(chunk):
    a, b, x0 = _inputs(64, (3, 4), seed=chunk, decay=True)
    pa, pb = _port(a), _port(b)
    full = engine.diagonal_scan(pa, pb, _port(x0))
    carry, parts = _port(x0), []
    for k in range(0, 64, chunk):
        st, carry = engine.diagonal_scan_carry(pa[k:k + chunk], pb[k:k + chunk], carry)
        parts.append(st)
    got = Goom(torch.cat([p.log_abs for p in parts]), torch.cat([p.sign for p in parts]))
    _close(got, full, _scale(a, b, x0))
    np.testing.assert_array_equal(n(carry.log_abs), n(got.log_abs[-1]))


def test_gradients_match_jax():
    """d(sum of state logs)/d(log planes) against JAX's autodiff of the same
    reference, on inputs with no exact zeros."""
    a, b, x0 = _inputs(17, (3, 4), seed=11, spread=20.0)

    def jax_loss(al, bl, xl):
        out = jax_scan.diagonal_scan(JGoom(al, jnp.asarray(a[1])), JGoom(bl, jnp.asarray(b[1])),
                                     JGoom(xl, jnp.asarray(x0[1])))
        return jnp.sum(out.log_abs)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(
        jnp.asarray(a[0]), jnp.asarray(b[0]), jnp.asarray(x0[0]))
    logs = [t(p[0]).requires_grad_() for p in (a, b, x0)]
    out = diagonal_scan_cuda(Goom(logs[0], t(a[1])), Goom(logs[1], t(b[1])),
                             Goom(logs[2], t(x0[1])))
    out.log_abs.sum().backward()
    for g, w in zip(logs, want):
        np.testing.assert_allclose(n(g.grad), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_wrapper_on_cpu_tensors_runs_the_plain_version():
    a, b, x0 = _inputs(9, (2, 5), seed=6)
    before = (diagonal_scan_cuda.launches, diagonal_scan_cuda.copies)
    got = diagonal_scan_cuda(_port(a), _port(b), _port(x0))
    want = goom_diag_scan_ref(_port(a), _port(b), _port(x0))
    np.testing.assert_array_equal(n(got.log_abs), n(want.log_abs))
    np.testing.assert_array_equal(n(got.sign), n(want.sign))
    assert (diagonal_scan_cuda.launches, diagonal_scan_cuda.copies) == before


def test_operands_go_in_by_strides_and_only_uncollapsible_ones_are_copied():
    L, di, ns = 4, 6, 3
    before = diagonal_scan_cuda.copies
    # Mamba's decay at batch 1: (B=1, L, di, n) transposed to (L, 1, di, n)
    la = torch.randn(1, L, di, ns).transpose(0, 1)
    log, _, st = scan_ops._channel_strides(la, torch.ones_like(la), (L, 1, di, ns), True)
    assert st == (di * ns, 1) and log.data_ptr() == la.data_ptr()
    # a sign plane that is one scalar expanded: stride 0 in time and channel
    one = torch.ones(())
    _, _, st = scan_ops._channel_strides(one, one, (L, 2, di), True)
    assert st == (0, 0)
    # x0 broadcast over a leading dim collapses too
    x0 = torch.randn(di, ns)
    _, _, st = scan_ops._channel_strides(x0, x0.sign(), (1, di, ns), False)
    assert st == (1,)
    assert diagonal_scan_cuda.copies == before
    # batch 2 and time transposed: no single stride walks (2, di, n)
    lb = torch.randn(2, L, di, ns).transpose(0, 1)
    _, _, st = scan_ops._channel_strides(lb, lb.sign(), (L, 2, di, ns), True)
    assert diagonal_scan_cuda.copies == before + 1
    assert st == (2 * di * ns, 1)
