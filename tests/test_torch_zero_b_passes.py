"""The zero-B matrix-scan kernel's three passes, emulated in numpy.

``csrc/matrix_scan_zero_b.cu`` computes X_t = (A_t ··· A_1) X_0 over chunks
of L steps (``zero_b_chunk_len``) as

  1. part:    each chunk's product P_c = A_end ··· A_start, walked in f64
              (A's exps f32, the carry's exps, the sum and the logs f64);
  2. stitch:  the state entering each chunk, X_in(c+1) = P_c X_in(c) from
              X_in(0) = x0, all in f64;
  3. fix-up:  each chunk walked again from X_in(c), X_t = A_t X_{t-1}, with
              f32 exps and sums and the carry's logs in f64, each X_t rounded
              to f32 once.

Each product is one "step" of the plain version's lmme_reference: rows
exponentiated against their detached (exact) maxima, the right operand's
columns against theirs, the contraction, the un-scaling in f64.  The
emulation does the same roundings in numpy (only the order of each sum
differs) and is held to float64 (the port's plain version in f64) and to
the JAX package's ``cumulative_lmme`` reference: its scale-normalised
distance to float64 is at most twice that of the f32 plain version of
either package.  The sequential walk (one f32 step per t, the previous
kernel's arithmetic) is the bar the passes must keep: a product of two long
chains cancels and magnifies f32 errors, which is why the part pass and the
stitch run in f64.  The card tests (``test_torch_cuda.py``) hold the kernel
itself to float64 and to the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jax_engine
from repro.core.goom import Goom as JGoom
from repro_torch.core.goom import Goom
from repro_torch.kernels.goom_scan import matrix_scan_zero_b_ref
from repro_torch.kernels.goom_scan.ops import zero_b_chunk_len
from torch_parity import goom_dist

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------
def _finite_or_zero(v):
    return np.where(np.isfinite(v), v, 0.0).astype(v.dtype)


def step(a_log, a_sign, x_log, x_sign, *, a_exps=np.float32, acc=np.float32):
    """One product A X of the kernel, batched over leading dims: A (..., d, d)
    with its exps in ``a_exps``, X (..., d, n) with f64 logs, its exps and
    the sum in ``acc``.  Returns (f64 logs, f32 signs)."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        rmax = _finite_or_zero(a_log.max(-1, keepdims=True))
        ae = (a_sign * np.exp((a_log - rmax).astype(a_exps))).astype(a_exps)
        cmax = _finite_or_zero(x_log.max(-2, keepdims=True))                 # f64
        xe = (x_sign * np.exp((x_log - cmax).astype(acc))).astype(acc)
        s = np.matmul(ae.astype(acc), xe).astype(acc)
        out = np.log(np.abs(s)).astype(np.float64) + rmax.astype(np.float64) + cmax
    return out, np.where(s >= 0, 1.0, -1.0).astype(np.float32)


def walk(a_log, a_sign, x_log, x_sign):
    """The previous kernel: one f32 step per t from x0, logs carried in f64."""
    cl, cs = x_log.astype(np.float64), x_sign
    out_l, out_s = [], []
    for t in range(a_log.shape[0]):
        cl, cs = step(a_log[t], a_sign[t], cl, cs)
        out_l.append(cl.astype(np.float32))
        out_s.append(cs)
    return np.stack(out_l), np.stack(out_s)


def three_passes(a_log, a_sign, x_log, x_sign):
    """X_t for a (T, d, d) and x0 (d, m) f32 planes, as the kernel's passes
    compute them; returns f32 planes (T, d, m)."""
    tlen, d = a_log.shape[0], a_log.shape[-1]
    ell = zero_b_chunk_len(tlen, d)
    k = -(-tlen // ell)
    starts = np.arange(k) * ell
    f64 = dict(acc=np.float64)
    # part: every chunk's product (the last chunk's is not needed)
    p_log, p_sign = a_log[starts].astype(np.float64), a_sign[starts].copy()
    for j in range(1, ell):
        live = starts + j < tlen
        ts = starts[live] + j
        p_log[live], p_sign[live] = step(a_log[ts], a_sign[ts], p_log[live],
                                         p_sign[live], **f64)
    # stitch: the state entering each chunk, P_c's exps in f64 too
    in_log = np.empty((k,) + x_log.shape, np.float64)
    in_sign = np.empty((k,) + x_log.shape, np.float32)
    in_log[0], in_sign[0] = x_log, x_sign
    for c in range(k - 1):
        in_log[c + 1], in_sign[c + 1] = step(p_log[c], p_sign[c], in_log[c], in_sign[c],
                                             a_exps=np.float64, **f64)
    # fix-up: each chunk walked again from its entering state
    out_log = np.empty((tlen,) + x_log.shape, np.float32)
    out_sign = np.empty((tlen,) + x_log.shape, np.float32)
    for j in range(ell):
        live = starts + j < tlen
        ts = starts[live] + j
        in_log[live], in_sign[live] = step(a_log[ts], a_sign[ts], in_log[live], in_sign[live])
        out_log[ts], out_sign[ts] = in_log[live].astype(np.float32), in_sign[live]
    return out_log, out_sign


# ---------------------------------------------------------------------------
# inputs and references
# ---------------------------------------------------------------------------
def _planes(x):
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):
        return np.log(np.abs(x)), np.where(x >= 0, 1.0, -1.0).astype(np.float32)


def _identity(d):
    log = np.where(np.eye(d, dtype=bool), 0.0, -np.inf).astype(np.float32)
    return log, np.ones((d, d), np.float32)


def operands(tlen, d, kind, seed=0):
    """``normal``: A with N(0, 1) entries; ``e200``: signed, every step shifted
    by e^±200, a tenth of the entries exact zeros and one all-zero row at
    t = 1 (when T > 1)."""
    rng = np.random.default_rng(seed)
    a_log, a_sign = _planes(rng.normal(size=(tlen, d, d)))
    if kind == "e200":
        a_log = a_log + np.where(rng.random((tlen, 1, 1)) < 0.5, -200.0, 200.0
                                 ).astype(np.float32)
        zero = rng.random(a_log.shape) < 0.1
        a_log[zero], a_sign[zero] = -np.inf, 1.0
        if tlen > 1:
            a_log[1, 0], a_sign[1, 0] = -np.inf, 1.0
    return a_log, a_sign


def _torch(planes, dtype=torch.float32):
    return Goom(*(torch.tensor(np.asarray(x), dtype=dtype) for x in planes))


def _jax_cumulative(a_log, a_sign):
    with jax_engine.use_backend("xla_reference"):
        out = jax.jit(jax_engine.cumulative_lmme)(JGoom(jnp.asarray(a_log),
                                                         jnp.asarray(a_sign)))
    return Goom(torch.tensor(np.asarray(out.log_abs)), torch.tensor(np.asarray(out.sign)))


def _scale(exact: Goom, kind: str, a, x0):
    """Each entry's scale: for ``normal`` the largest entry of its matrix
    (long products turn rank-1), for ``e200`` the same scan on |values|."""
    if kind == "normal":
        return exact.log_abs.amax((-2, -1), keepdim=True).expand_as(exact.log_abs)
    ones = [np.ones_like(a[1]), np.ones_like(x0[1])]
    return matrix_scan_zero_b_ref(_torch((a[0], ones[0]), torch.float64),
                                  _torch((x0[0], ones[1]), torch.float64)).log_abs


def check_no_worse(got, plain, exact, scale):
    """Distance to float64 at most twice the f32 plain version's (floor
    1e-6: some sixteen f32 roundings of a unit value)."""
    d_got, d_plain = goom_dist(got, exact, scale), goom_dist(plain, exact, scale)
    assert d_got <= 2.0 * d_plain + 1e-6, (d_got, d_plain)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def _lengths(d):
    ell = zero_b_chunk_len(64, d)   # T around one chunk of a 64-step scan
    return sorted({1, ell - 1, ell, ell + 1, 4097} - {0})


CASES = [(tlen, d, kind) for d in (3, 16) for tlen in _lengths(d)
         for kind in ("normal", "e200")] + [(20, 128, "normal"), (20, 128, "e200")]


@pytest.mark.parametrize("tlen,d,kind", CASES)
def test_three_passes_match_float64_and_jax(tlen, d, kind):
    """X_0 = I (``cumulative_lmme``): the emulation against float64, the
    port's f32 plain version and JAX's reference."""
    a = operands(tlen, d, kind, seed=tlen + d)
    x0 = _identity(d)
    got = _torch(three_passes(*a, *x0))
    exact = matrix_scan_zero_b_ref(_torch(a, torch.float64), _torch(x0, torch.float64))
    plain = matrix_scan_zero_b_ref(_torch(a), _torch(x0))
    scale = _scale(exact, kind, a, x0)
    assert got.shape == plain.shape and not torch.isnan(got.log_abs).any()
    check_no_worse(got, plain, exact, scale)
    if tlen <= 64 or d == 3:   # JAX's scan of 4097 16x16 steps compiles slowly
        check_no_worse(got, _jax_cumulative(*a), exact, scale)
    # and within 1.5 times the sequential walk's distance (floor 1e-6)
    d_walk = goom_dist(_torch(walk(*a, *x0)), exact, scale)
    assert goom_dist(got, exact, scale) <= 1.5 * d_walk + 1e-6
    # exact zeros stay exact: an all-zero row of A_1 is one in X_1
    if kind == "e200" and tlen > 1:
        assert bool((got.log_abs[1, 0] == -np.inf).all())
        assert bool((got.sign[1, 0] == 1.0).all())


@pytest.mark.parametrize("m,kind", [(1, "normal"), (5, "e200")])
def test_three_passes_from_a_general_x0(m, kind):
    """x0 of another width, signed, with an all-zero column: the emulation
    against float64 and the f32 plain version (the prefix products folded
    with x0)."""
    d, tlen = 16, 70
    a = operands(tlen, d, kind, seed=m)
    rng = np.random.default_rng(10 + m)
    x0 = _planes(rng.normal(size=(d, m)))
    x0[0][:, 0], x0[1][:, 0] = -np.inf, 1.0
    got = _torch(three_passes(*a, *x0))
    exact = matrix_scan_zero_b_ref(_torch(a, torch.float64), _torch(x0, torch.float64))
    plain = matrix_scan_zero_b_ref(_torch(a), _torch(x0))
    scale = _scale(exact, "e200", a, x0)
    check_no_worse(got, plain, exact, scale)
    assert bool((got.log_abs[..., 0] == -np.inf).all())


@pytest.mark.parametrize("d", [3, 16, 128])
def test_chunk_len_is_a_function_of_t_and_d(d):
    """L is fixed by (T, d): the same for every G, m and call; a power of
    two; the least with 2 L^2 >= T (near the L = sqrt(T / 2) that minimises
    the depth 2 L + T / L of the passes) whose part pass, one block per
    chunk and column tile, fits the card's 132 SMs at once."""
    tiles = 1 if d <= 16 else -(-d // 32)

    def fits(ell, tlen):
        return 2 * ell * ell >= tlen and ell * 132 >= tlen * tiles

    for tlen in (1, 2, 3, 15, 16, 17, 63, 64, 65, 1000, 2001, 4097):
        ell = zero_b_chunk_len(tlen, d)
        assert ell == zero_b_chunk_len(tlen, d)
        assert ell >= 1 and ell & (ell - 1) == 0
        assert fits(ell, tlen) and (ell == 1 or not fits(ell // 2, tlen))
    assert zero_b_chunk_len(2001, d) == (64 if d == 128 else 32)
    assert zero_b_chunk_len(4097, d) == (128 if d == 128 else 64)
