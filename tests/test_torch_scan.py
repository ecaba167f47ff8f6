"""The port's scans against the JAX package, on the CPU.

* ``associative_scan`` brackets as ``jax.lax.associative_scan`` does, shown
  with a combine that is not associative, so that its result spells out the
  bracketing;
* ``engine.matrix_scan`` (with and without x0), ``matrix_scan_carry`` chunked
  against full, and ``engine.cumulative_lmme`` hold to JAX's engine under
  ``use_backend("xla_reference")`` at ``tests/test_engine.py``'s tolerances;
* ``selective_reset_scan``'s states match JAX's and its reset flags are equal;
* the matrix-scan wrapper's plain path and its stride handling.

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
from repro.core.ops import goom_norm as j_goom_norm
from repro.core.ops import goom_normalize_cols as j_normalize_cols
from repro_torch.core import engine
from repro_torch.core.chains import goom_log_norm
from repro_torch.core.goom import Goom, to_goom
from repro_torch.core.ops import goom_norm, goom_normalize_cols
from repro_torch.core.scan import associative_scan, colinearity_select, orthonormal_reset
from repro_torch.kernels.goom_scan import (
    matrix_scan_cuda,
    matrix_scan_ref,
    matrix_scan_zero_b_ref,
)
from repro_torch.kernels.goom_scan import ops as scan_ops
from torch_parity import assert_goom_close, goom_dist, n, t

torch.set_num_threads(2)


def _goom_np(x):
    """numpy reals -> (log, sign) f32 planes, as both packages' ``to_goom``."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):
        return np.log(np.abs(x)), np.where(x >= 0, 1.0, -1.0).astype(np.float32)


def _port(planes) -> Goom:
    return Goom(t(planes[0]), t(planes[1]))


def _jax(planes) -> JGoom:
    return JGoom(jnp.asarray(planes[0]), jnp.asarray(planes[1]))


def _jax_ref(fn, *args):
    """``fn`` under JAX's reference backend, jitted: one compile instead of
    one per op."""
    with jax_engine.use_backend("xla_reference"):
        return jax.jit(fn)(*args)


def _abs(g: Goom) -> Goom:
    return Goom(g.log_abs, torch.ones_like(g.sign))


def _close(got, want, scale: Goom):
    """``assert_goom_close`` with each entry's own scale: ``scale`` is the
    same scan run on |values| (all signs +1), the size of the sum an entry
    is before its terms cancel.  Values over that scale agree to 1e-4; logs
    agree to ``tests/test_engine.py``'s rtol 1e-4 / atol 1e-3, and signs
    exactly, wherever the entry is within e^8 of its scale.  Below that, f32
    rounding (6e-8) times the cancellation (e^8 ≈ 3000) reaches the 1e-4
    relative bar, and the two packages, summing in other orders, may
    legitimately differ."""
    assert_goom_close(got.log_abs, got.sign, want.log_abs, want.sign,
                      scale_log=scale.log_abs, cancel_margin=8.0)


def _matrix_max(g: Goom) -> torch.Tensor:
    """Each matrix's largest log, as every entry's scale."""
    return g.log_abs.amax((-2, -1), keepdim=True).expand_as(g.log_abs)


def _no_worse_than_jax(got, want, exact):
    """For products that turn nearly rank-1, where whole rows cancel: over
    each matrix's largest entry, the port's distance to the float64 plain
    version is at most twice JAX's."""
    scale = _matrix_max(exact)
    d_port, d_jax = goom_dist(got, exact, scale), goom_dist(want, exact, scale)
    assert d_port <= 2.0 * d_jax + 1e-6, (d_port, d_jax)


# ---------------------------------------------------------------------------
# associative_scan: JAX's bracketing
# ---------------------------------------------------------------------------
def _mix(e, l):
    """Not associative: (e∘l)∘r != e∘(l∘r), so the scan's result is a
    fingerprint of its bracketing.  Exact in int32 and int64."""
    return (3 * e + 5 * l + 1) % 10007


@pytest.mark.parametrize("length", [1, 2, 3, 4, 5, 7, 8, 13, 64, 100, 129])
def test_associative_scan_brackets_as_jax(length):
    x = np.random.default_rng(length).integers(0, 10007, size=(length, 3)).astype(np.int32)
    want = np.asarray(jax.jit(lambda v: jax.lax.associative_scan(_mix, v))(jnp.asarray(x)))
    got = associative_scan(_mix, torch.tensor(x, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), want)
    # tuples of tensors pair up the same way
    pair = lambda e, l: (_mix(e[0], l[1]), _mix(e[1], l[0]))  # noqa: E731
    want = jax.jit(lambda v: jax.lax.associative_scan(pair, v))(
        (jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1])))
    got = associative_scan(pair, (torch.tensor(x[:, 0], dtype=torch.int64),
                                  torch.tensor(x[:, 1], dtype=torch.int64)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_associative_scan_of_matrix_products_is_the_running_product():
    """A non-commutative combine: exact integer matrix products, later on
    the left, as ``cumulative_lmme`` composes."""
    m = np.random.default_rng(0).integers(-2, 3, size=(11, 3, 3))
    got = associative_scan(lambda e, l: l @ e, torch.tensor(m))
    p = np.eye(3, dtype=np.int64)
    for i in range(11):
        p = m[i] @ p
        np.testing.assert_array_equal(got[i].numpy(), p)


# ---------------------------------------------------------------------------
# matrix scan
# ---------------------------------------------------------------------------
def _scan_inputs(tlen, batch, d, m, seed=0, scale=0.6):
    rng = np.random.default_rng(seed)
    a = _goom_np(rng.normal(size=(tlen,) + batch + (d, d)) * scale)
    b = _goom_np(rng.normal(size=(tlen,) + batch + (d, m)) * scale)
    x0 = _goom_np(rng.normal(size=batch + (d, m)))
    return a, b, x0


@pytest.mark.parametrize("tlen,batch,d,m", [(13, (), 4, 1), (9, (2,), 5, 3),
                                           (16, (2, 2), 3, 1), (5, (), 8, 8),
                                           (300, (2,), 3, 2)])
@pytest.mark.parametrize("with_x0", [True, False])
def test_matrix_scan_matches_jax(tlen, batch, d, m, with_x0):
    a, b, x0 = _scan_inputs(tlen, batch, d, m)
    x0_p, x0_j = (_port(x0), _jax(x0)) if with_x0 else (None, None)
    want = _jax_ref(jax_engine.matrix_scan, _jax(a), _jax(b), x0_j)
    got = engine.matrix_scan(_port(a), _port(b), x0_p)
    assert got.shape == want.shape
    _close(got, want, engine.matrix_scan(_abs(_port(a)), _abs(_port(b)),
                                         None if x0_p is None else _abs(x0_p)))


def test_matrix_scan_no_x0_and_zero_bias():
    rng = np.random.default_rng(7)
    a = _goom_np(rng.normal(size=(11, 4, 4)) * 0.5)
    b_log = np.full((11, 4, 2), -np.inf, np.float32)
    b_log[0] = 0.0  # B_1 = 1, the rest exact zeros
    b = (b_log, np.ones_like(b_log))
    want = _jax_ref(jax_engine.matrix_scan, _jax(a), _jax(b), None)
    got = engine.matrix_scan(_port(a), _port(b))
    mask = np.isfinite(n(want.log_abs))
    assert np.array_equal(mask, np.isfinite(n(got.log_abs)))
    np.testing.assert_allclose(n(got.log_abs)[mask], n(want.log_abs)[mask],
                               rtol=1e-4, atol=1e-3)


def _e200_inputs(signed, seed=0):
    rng = np.random.default_rng(seed)
    tlen, d, m = 17, 4, 2
    shifts = 200.0 * rng.choice([-1.0, 1.0], size=(tlen, 1, 1))

    def real(shape):
        v = rng.normal(size=shape)
        return v if signed else np.abs(v) + 0.1

    al, asn = _goom_np(real((tlen, d, d)))
    return (al + shifts.astype(np.float32), asn), _goom_np(real((tlen, d, m))), \
        _goom_np(real((d, m)))


def test_matrix_scan_e200_positive_within_1e_4_relative():
    a, b, x0 = _e200_inputs(signed=False)
    want = _jax_ref(jax_engine.matrix_scan, _jax(a), _jax(b), _jax(x0))
    got = engine.matrix_scan(_port(a), _port(b), _port(x0))
    w = n(want.log_abs)
    assert np.abs(w).max() > 200.0  # the range was reached
    rel = np.abs(n(got.log_abs) - w) / np.maximum(np.abs(w), 1.0)
    assert rel.max() <= 1e-4


def test_matrix_scan_e200_signed_row_normalised():
    a, b, x0 = _e200_inputs(signed=True)
    want = _jax_ref(jax_engine.matrix_scan, _jax(a), _jax(b), _jax(x0))
    got = engine.matrix_scan(_port(a), _port(b), _port(x0))
    w_log, g_log = n(want.log_abs), n(got.log_abs)
    scale = np.maximum(w_log.max(-1, keepdims=True), g_log.max(-1, keepdims=True))
    ok = w_log > scale - 12.0  # away from catastrophic cancellation
    rel = np.abs(g_log - w_log) / np.maximum(np.abs(w_log), 1.0)
    assert rel[ok].max() <= 1e-3
    gv = n(got.sign) * np.exp(g_log - scale)
    wv = n(want.sign) * np.exp(w_log - scale)
    np.testing.assert_allclose(gv, wv, atol=1e-3, rtol=0)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_matrix_scan_carry_chunked_matches_full_e200(chunk):
    """As ``tests/test_serve_engine.py``: positive operands whose compounds
    sweep past e±200; chunks threaded through the carry equal one scan."""
    rng = np.random.default_rng(2)
    a = _port(_goom_np(np.abs(rng.normal(size=(150, 4, 4))) * 4.0))
    b = _port(_goom_np(np.abs(rng.normal(size=(150, 4, 1)))))
    full = engine.matrix_scan(a, b)
    assert float(full.log_abs.abs().max()) > 200.0
    engine.reset_calls()
    outs, carry = [], None
    for s in range(0, 150, chunk):
        st, carry = engine.matrix_scan_carry(a[s:s + chunk], b[s:s + chunk], carry)
        outs.append(st)
    assert engine.calls["matrix_scan_carry"] == engine.calls["matrix_scan"] == len(outs)
    np.testing.assert_array_equal(n(carry.log_abs), n(outs[-1].log_abs[-1]))
    got = Goom(torch.cat([o.log_abs for o in outs]), torch.cat([o.sign for o in outs]))
    np.testing.assert_allclose(n(got.log_abs), n(full.log_abs), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(n(got.sign), n(full.sign))
    want = _jax_ref(jax_engine.matrix_scan,
                    JGoom(jnp.asarray(n(a.log_abs)), jnp.asarray(n(a.sign))),
                    JGoom(jnp.asarray(n(b.log_abs)), jnp.asarray(n(b.sign))))
    _close(full, want, full)  # positive operands: each entry is its own scale


def test_matrix_scan_gradients_match_jax():
    a, b, x0 = _scan_inputs(6, (), 3, 2, seed=3, scale=0.7)
    w = np.random.default_rng(4).normal(size=(6, 3, 2)).astype(np.float32)

    def jloss(al, bl):
        out = jax_engine.matrix_scan(JGoom(al, jnp.asarray(a[1])),
                                     JGoom(bl, jnp.asarray(b[1])), _jax(x0))
        return jnp.sum(out.log_abs * w)

    jg = _jax_ref(jax.grad(jloss, argnums=(0, 1)), jnp.asarray(a[0]), jnp.asarray(b[0]))
    al, bl = t(a[0]).requires_grad_(), t(b[0]).requires_grad_()
    out = engine.matrix_scan(Goom(al, t(a[1])), Goom(bl, t(b[1])), _port(x0))
    (out.log_abs * t(w)).sum().backward()
    np.testing.assert_allclose(n(al.grad), n(jg[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(bl.grad), n(jg[1]), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# cumulative LMME and the zero-B form
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tlen,d", [(10, 3), (33, 5), (1000, 16)])
def test_cumulative_lmme_matches_jax(tlen, d):
    mats = _goom_np(np.random.default_rng(tlen).normal(size=(tlen, d, d)))
    want = _jax_ref(jax_engine.cumulative_lmme, _jax(mats))
    engine.reset_calls()
    got = engine.cumulative_lmme(_port(mats))
    assert engine.calls["cumulative_lmme"] == 1
    if tlen <= 33:
        _close(got, want, engine.cumulative_lmme(_abs(_port(mats))))
        return
    # the quickstart's (1000, 16, 16) chain: by the end the products are
    # rank-1 to f32 precision, so hold both packages to float64 instead
    exact = engine.cumulative_lmme(Goom(*(torch.tensor(x, dtype=torch.float64)
                                          for x in mats)))
    _no_worse_than_jax(got, want, exact)
    fro = [float(goom_log_norm(g[-1])) for g in (got, exact)]
    assert abs(fro[0] - fro[1]) <= 1e-5 * abs(fro[1])


def test_zero_b_form_is_the_prefix_products_applied_to_x0():
    """``matrix_scan_cuda(a, None, x0)`` on the CPU: the plain zero-B version,
    equal to the full recurrence with B = 0 and to JAX's prefix products
    folded with x0."""
    rng = np.random.default_rng(5)
    a = _goom_np(rng.normal(size=(12, 4, 4)))
    x0 = _goom_np(rng.normal(size=(4, 3)))
    got = matrix_scan_cuda(_port(a), None, _port(x0))
    zeros = Goom(torch.full((12, 4, 3), -torch.inf), torch.ones(12, 4, 3))
    full = matrix_scan_ref(_port(a), zeros, _port(x0))
    scale = matrix_scan_cuda(_abs(_port(a)), None, _abs(_port(x0)))
    _close(got, full, scale)
    want = _jax_ref(lambda a_, x_: jax_engine.lmme(jax_engine.cumulative_lmme(a_), x_),
                    _jax(a), _jax(x0))
    _close(got, want, scale)
    with pytest.raises(ValueError, match="needs x0"):
        matrix_scan_cuda(_port(a), None)


def test_cumulative_lmme_survives_growth_beyond_floats():
    mats = _goom_np(np.random.default_rng(0).normal(size=(512, 8, 8)))
    out = engine.cumulative_lmme(_port(mats))
    assert torch.isfinite(out.log_abs).all()
    assert float(out.log_abs[-1].max()) > 100.0  # far beyond f32's ~88


# ---------------------------------------------------------------------------
# the wrapper on the CPU: the plain version, and operands passed by strides
# ---------------------------------------------------------------------------
def test_wrapper_on_cpu_tensors_runs_the_plain_version():
    a, b, x0 = _scan_inputs(9, (2,), 5, 3, seed=6)
    before = (matrix_scan_cuda.launches, matrix_scan_cuda.launches_zero_b)
    got = matrix_scan_cuda(_port(a), _port(b), _port(x0))
    want = matrix_scan_ref(_port(a), _port(b), _port(x0))
    np.testing.assert_array_equal(n(got.log_abs), n(want.log_abs))
    got0 = matrix_scan_cuda(_port(a), None, _port(x0))
    want0 = matrix_scan_zero_b_ref(_port(a), _port(x0))
    np.testing.assert_array_equal(n(got0.log_abs), n(want0.log_abs))
    assert (matrix_scan_cuda.launches, matrix_scan_cuda.launches_zero_b) == before


def test_operands_go_in_by_strides_and_only_uncollapsible_ones_are_copied():
    s, h, d, bsz = 5, 3, 4, 2
    a = torch.randn(h, d, d)
    before = matrix_scan_cuda.copies
    # the generic layer's A: a stride-0 view over time, never materialised
    al, _, st = scan_ops._strides(a, a.sign(), (s, h, d, d), True)
    assert tuple(st) == (0, d * d, d, 1) and al.data_ptr() == a.data_ptr()
    # its B·u columns: (S,B,H,d,1) permuted to (S,H,d,B)
    bu = torch.randn(s, bsz, h, d, 1)[..., 0].permute(0, 2, 3, 1)
    _, _, st = scan_ops._strides(bu, bu.sign(), (s, h, d, bsz), True)
    assert tuple(st) == (bsz * h * d, d, 1, h * d)
    # x0 broadcast over a leading batch dim: stride 0 collapses too
    x0 = torch.randn(d, bsz)
    _, _, st = scan_ops._strides(x0, x0.sign(), (h, d, bsz), False)
    assert tuple(st) == (0, bsz, 1)
    assert matrix_scan_cuda.copies == before
    # batch (2, 3) with the 2 broadcast: no single stride walks it
    a2 = torch.randn(1, 3, d, d)
    _, _, st = scan_ops._strides(a2, a2.sign(), (s, 2, 3, d, d), True)
    assert matrix_scan_cuda.copies == before + 1
    assert tuple(st) == (2 * 3 * d * d, d * d, d, 1)


# ---------------------------------------------------------------------------
# selective resetting
# ---------------------------------------------------------------------------
def _lorenz_like(tlen, seed):
    """Near-identity 3x3 steps with a dominant stretch: states turn
    colinear within a few steps, so resets fire."""
    rng = np.random.default_rng(seed)
    js = np.eye(3) + 0.05 * rng.normal(size=(tlen, 3, 3))
    js[:, 0, 0] += 0.5
    js[0] = np.eye(3)
    return js.astype(np.float32)


@pytest.mark.parametrize("case", ["normal", "lorenz_like", "always_ungated"])
def test_selective_reset_scan_states_and_flags_match_jax(case):
    if case == "normal":
        mats = np.random.default_rng(0).normal(size=(16, 3, 3)) * 2.0
        sel, gated = 0.995, True
    elif case == "lorenz_like":
        mats, sel, gated = _lorenz_like(40, 1), 0.99, True
    else:
        mats, sel, gated = np.random.default_rng(2).normal(size=(24, 4, 4)), None, False
    g = _goom_np(mats)
    if sel is None:
        j_sel = lambda x: jnp.ones(x.shape[:-2], bool)  # noqa: E731
        p_sel = lambda x: torch.ones(x.shape[:-2], dtype=torch.bool)  # noqa: E731
    else:
        j_sel, p_sel = jax_scan.colinearity_select(sel), colinearity_select(sel)
    want, want_flags = _jax_ref(
        lambda x: jax_engine.selective_reset_scan(
            x, j_sel, jax_scan.orthonormal_reset(), reset_only_state_compounds=gated),
        _jax(g))
    engine.reset_calls()
    got, flags = engine.selective_reset_scan(
        _port(g), p_sel, orthonormal_reset(), reset_only_state_compounds=gated)
    assert engine.calls["selective_reset_scan"] == 1 and engine.calls["lmme"] > 0
    np.testing.assert_array_equal(flags.numpy(), np.asarray(want_flags))
    assert flags.any()
    # resets make the states signed bases: values over each matrix's largest
    assert goom_dist(got, want, _matrix_max(got)) <= 1e-4


def test_colinearity_select_and_orthonormal_reset_match_jax():
    rng = np.random.default_rng(3)
    v = np.ones((4, 1)) @ np.array([[1.0, 1.001, 0.999, 1.0]])  # rank 1
    q, _ = np.linalg.qr(rng.normal(size=(4, 4)))
    batch = _goom_np(np.stack([v, q, rng.normal(size=(4, 4))]))
    want = jax_scan.colinearity_select(0.99)(_jax(batch))
    got = colinearity_select(0.99)(_port(batch))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [True, False, bool(want[2])]
    a = _goom_np(rng.normal(size=(5, 5)) * np.exp(rng.normal(size=(5, 5)) * 5))
    want = jax_scan.orthonormal_reset()(_jax(a))
    got = orthonormal_reset()(_port(a))
    np.testing.assert_allclose(n(torch.exp(got.log_abs) * got.sign),
                               np.asarray(jnp.exp(want.log_abs) * want.sign), atol=1e-5)


def test_goom_norm_and_normalize_cols_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3)) * np.exp(rng.normal(size=(2, 1, 3)) * 50)
    x[0, :, 1] = 0.0  # an all-zero column stays unscaled, not NaN
    g = _goom_np(x)
    np.testing.assert_allclose(n(goom_norm(_port(g), dim=-2)),
                               np.asarray(j_goom_norm(_jax(g), axis=-2)), rtol=1e-6)
    got, want = goom_normalize_cols(_port(g)), j_normalize_cols(_jax(g))
    assert np.all(n(got.log_abs)[0, :, 1] == -np.inf)
    np.testing.assert_allclose(n(got.log_abs), np.asarray(want.log_abs), rtol=1e-6, atol=1e-5)
    # the norm is detached, as in JAX's stop_gradient
    lg = t(g[0]).requires_grad_()
    goom_normalize_cols(Goom(lg, t(g[1]))).log_abs.sum().backward()
    np.testing.assert_array_equal(n(lg.grad), np.ones_like(g[0]))


def test_to_goom_planes_agree_with_the_helper():
    x = np.array([[2.5, -3.0], [0.0, 1e-30]], np.float32)
    g = to_goom(torch.tensor(x))
    ref = _goom_np(x)
    np.testing.assert_array_equal(n(g.log_abs), ref[0])
    np.testing.assert_array_equal(n(g.sign), ref[1])
