"""The with-B matrix-scan kernel's arithmetic, emulated in numpy.

``csrc/matrix_scan.cu`` computes X_t = A_t X_{t-1} ⊕ B_t at d <= 32 over K
chunks of L = ``with_b_chunk_len(T, d)`` steps, all in one block:

  1. part:    each chunk's state from a zero start, B*_c, walked in f32 (the
              carry's logs f64); for a time-varying A also the chunk's
              product P_c = A_end ··· A_start, walked in f64; for a
              time-invariant A, P = A^L by log2 L squarings in f64;
  2. stitch:  X_in(0) = x0, X_in(c+1) = P_c X_in(c) ⊕ B*_c, a walk's f32
              step on P's f64 logs;
  3. fix-up:  each chunk walked again from X_in(c) in f32, each X_t rounded
              to f32 once.

One step is the plain version's lmme_reference (rows against their detached
maxima, the right operand's columns against theirs, the contraction, the
un-scaling in f64) with the bias folded into the contraction's sum when its
exponent in the step's scale is within 80 e-folds (1e-35 .. 5e34 in f32),
and the signed LSE otherwise.  The emulation does the same roundings (only
the order of each sum differs) and is held to float64 (the port's plain
version in f64) and to the JAX package's ``engine.matrix_scan`` reference:
its scale-normalised distance to float64 is at most twice that of the f32
plain version of either package, and at most twice the sequential walk's
(L = T, the same kernel's one-chunk form).  The card tests
(``test_torch_cuda.py``) hold the kernel itself to float64 and to the plain
version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jax_engine
from repro.core.goom import Goom as JGoom
from repro_torch.core.goom import Goom
from repro_torch.kernels.goom_scan import matrix_scan_ref
from repro_torch.kernels.goom_scan.ops import WALK_MAX_T, with_b_chunk_len
from torch_parity import goom_dist

torch.set_num_threads(2)

F32, F64 = np.float32, np.float64
LIN_MAX = {F32: 80.0, F64: 700.0}  # Lin<AT>::kMax in csrc/matrix_scan.cu


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------
def _finite_or_zero(v):
    return np.where(np.isfinite(v), v, 0.0).astype(v.dtype)


def left_exps(l_log, l_sign, mt):
    """Rows of the left operand: sign * exp(log - row max) in ``mt`` and the
    row maxima in f64 (the max taken in the logs' own type)."""
    with np.errstate(invalid="ignore"):
        rm = _finite_or_zero(l_log.max(-1, keepdims=True))
        e = (l_sign * np.exp((l_log - rm).astype(mt))).astype(mt)
    return e, rm.astype(F64)


def step(le, rm, x_log, x_sign, b_log=None, b_sign=None, *, acc=F32):
    """One step M x ⊕ b, batched over leading dims: M's row exps ``le`` and
    row maxima ``rm`` from ``left_exps``, x (..., d, n) with f64 logs, b of
    x's shape or None.  Returns (f64 logs, f32 signs)."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore", under="ignore"):
        cmax = _finite_or_zero(x_log.max(-2, keepdims=True))
        xe = (x_sign * np.exp((x_log - cmax).astype(acc))).astype(acc)
        sc = rm + cmax
        s = np.matmul(le.astype(acc), xe).astype(acc)
        if b_log is None:
            return np.log(np.abs(s)).astype(F64) + sc, np.where(s >= 0, 1.0, -1.0).astype(F32)
        bp = b_log - sc
        lin = np.abs(bp) < LIN_MAX[acc]
        eb = np.where(lin, b_sign * np.exp(bp.astype(acc)), 0.0).astype(acc)
        s = (s + eb).astype(acc)
        out = np.log(np.abs(s)).astype(F64) + sc
        sg = np.where(s >= 0, 1.0, -1.0).astype(F32)
        # far from the step's scale: the signed LSE
        slow = ~lin & (b_log != -np.inf)
        mx = _finite_or_zero(np.maximum(out, b_log))
        sm = (sg * np.exp((out - mx).astype(acc))
              + b_sign * np.exp((b_log - mx).astype(acc))).astype(acc)
        out = np.where(slow, np.log(np.abs(sm)).astype(F64) + mx, out)
        sg = np.where(slow, np.where(sm >= 0, 1.0, -1.0), sg).astype(F32)
    return out, sg


def kernel(a_log, a_sign, b_log, b_sign, x_log, x_sign, *, fixed, ell=None):
    """All states as the kernel computes them: a (T or 1, G, d, d), b
    (T, G, d, m), x0 (G, d, m) f32 planes (x0 = None: exact zeros).
    ``ell`` overrides the chunk length (``ell=T``: the sequential walk)."""
    tlen, d = b_log.shape[0], a_log.shape[-1]
    if x_log is None:
        x_log = np.full(b_log.shape[1:], -np.inf, F32)
        x_sign = np.ones(b_log.shape[1:], F32)
    ell = ell or with_b_chunk_len(tlen, d)
    k = -(-tlen // ell)

    def a_at(t):
        return a_log[0 if fixed else t], a_sign[0 if fixed else t]

    # 1. part: B*_c in f32; P_c walked (time-varying A) or squared, in f64
    bs, ps = [], []
    for c in range(k - 1):
        s0 = c * ell
        bl, bsg = b_log[s0].astype(F64), b_sign[s0]
        pl, psg = a_at(s0)
        pl = pl.astype(F64)
        for t in range(s0 + 1, s0 + ell):
            le, rm = left_exps(*a_at(t), F32)
            bl, bsg = step(le, rm, bl, bsg, b_log[t], b_sign[t])
            if not fixed:
                pl, psg = step(le, rm, pl, psg, acc=F64)
        bs.append((bl, bsg))
        ps.append((pl, psg))
    if fixed and k > 1:
        pl, psg = a_log[0].astype(F64), a_sign[0]
        for _ in range(ell.bit_length() - 1):  # log2 L squarings
            pl, psg = step(*left_exps(pl, psg, F64), pl, psg, acc=F64)
        ps = [(pl, psg)] * (k - 1)
    # 2. stitch: an f32 step on P's f64 logs
    xin = [(x_log.astype(F64), x_sign)]
    for c in range(k - 1):
        xin.append(step(*left_exps(*ps[c], F32), *xin[c], *bs[c]))
    # 3. fix-up: every chunk walked again from its entering state
    out_l = np.empty(b_log.shape, F32)
    out_s = np.empty(b_log.shape, F32)
    for c in range(k):
        cl, cs = xin[c]
        for t in range(c * ell, min((c + 1) * ell, tlen)):
            cl, cs = step(*left_exps(*a_at(t), F32), cl, cs, b_log[t], b_sign[t])
            out_l[t], out_s[t] = cl.astype(F32), cs
    return out_l, out_s


# ---------------------------------------------------------------------------
# inputs and references
# ---------------------------------------------------------------------------
def _planes(x):
    x = np.asarray(x, F32)
    with np.errstate(divide="ignore"):
        return np.log(np.abs(x)), np.where(x >= 0, 1.0, -1.0).astype(F32)


def operands(tlen, g, d, m, kind, seed=0):
    """(a, b, x0, fixed) f32 planes.  ``shared_a``: the generic layer's
    near-identity A, one per head and time-invariant; ``positive``: the
    e±200 chain of test_serve_engine.py (|4 N(0,1)| steps, x0 = None);
    ``signed``: time-varying 0.6 N(0,1); ``e200``: every step shifted by
    e^±200."""
    rng = np.random.default_rng(seed)
    if kind == "shared_a":
        a = _planes((0.9 * np.eye(d) + 0.3 * rng.normal(size=(g, d, d)) / d ** 0.5)[None])
        b, x0 = rng.normal(size=(tlen, g, d, m)), rng.normal(size=(g, d, m))
        return a, _planes(b), _planes(x0), True
    if kind == "positive":
        return (_planes(np.abs(rng.normal(size=(tlen, g, d, d))) * 4.0),
                _planes(np.abs(rng.normal(size=(tlen, g, d, m)))), None, False)
    scale = 0.6 if kind == "signed" else 1.0
    a = _planes(rng.normal(size=(tlen, g, d, d)) * scale)
    if kind == "e200":
        a = (a[0] + np.where(rng.random((tlen, 1, 1, 1)) < 0.5, -200.0, 200.0).astype(F32), a[1])
    b, x0 = rng.normal(size=(tlen, g, d, m)) * scale, rng.normal(size=(g, d, m))
    return a, _planes(b), _planes(x0), False


def _torch(planes, shape=None, dtype=torch.float32):
    if planes is None:
        return None
    log, sign = (torch.tensor(np.asarray(x), dtype=dtype) for x in planes)
    if shape is not None:
        log, sign = log.expand(shape), sign.expand(shape)
    return Goom(log, sign)


def _abs(g):
    return None if g is None else Goom(g.log_abs, torch.ones_like(g.sign))


def _jax_scan(a, b, x0):
    def fn(al, asg, bl, bsg, xl, xs):
        x = None if xl is None else JGoom(xl, xs)
        return jax_engine.matrix_scan(JGoom(al, asg), JGoom(bl, bsg), x)

    args = [jnp.asarray(v) for v in (*a, *b)] + \
        ([None, None] if x0 is None else [jnp.asarray(v) for v in x0])
    with jax_engine.use_backend("xla_reference"):
        out = jax.jit(fn)(*args)
    return Goom(torch.tensor(np.asarray(out.log_abs)), torch.tensor(np.asarray(out.sign)))


def distances(tlen, g, d, m, kind, seed=0):
    """Distances to float64 of the emulated kernel, its one-chunk walk, the
    port's f32 plain version and JAX's reference."""
    a, b, x0, fixed = operands(tlen, g, d, m, kind, seed)
    shape = (tlen, g, d, d)
    got = _torch(kernel(*a, *b, *(x0 or (None, None)), fixed=fixed))
    walk = _torch(kernel(*a, *b, *(x0 or (None, None)), fixed=fixed, ell=tlen))
    plain = matrix_scan_ref(_torch(a, shape), _torch(b), _torch(x0))
    f64 = torch.float64
    exact = matrix_scan_ref(_torch(a, shape, f64), _torch(b, None, f64), _torch(x0, None, f64))
    # each entry against the scan of |values|
    scale = matrix_scan_ref(_abs(_torch(a, shape, f64)), _abs(_torch(b, None, f64)),
                            _abs(_torch(x0, None, f64))).log_abs
    assert got.shape == plain.shape and not torch.isnan(got.log_abs).any()
    a_full = tuple(np.broadcast_to(v, shape) for v in a)
    return {"kernel": goom_dist(got, exact, scale), "walk": goom_dist(walk, exact, scale),
            "plain": goom_dist(plain, exact, scale),
            "jax": goom_dist(_jax_scan(a_full, b, x0), exact, scale)}


def check(dist):
    """At most twice the f32 plain version's distance (either package) and
    twice the one-chunk walk's (floor 1e-6: some sixteen f32 roundings of a
    unit value)."""
    for ref in ("plain", "jax", "walk"):
        if ref in dist:  # the rank-deficient chains have no JAX reference
            assert dist["kernel"] <= 2.0 * dist[ref] + 1e-6, (ref, dist)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
# (T, G, d, m, kind): chip_smoke.py's SCAN_CASES at d <= 32 (the generic
# layer's decode and 64-token chunk, a time-varying A over 256 steps at its
# widths, the JAX tests' e±200 and odd signed shapes), the generic path's
# batch-1 tail token, and T around the chunk lengths (up to 24 walks in one
# chunk, 25 and 63 end in a ragged chunk, 65 has a one-step last chunk)
CASES = [
    (1, 48, 16, 4, "shared_a"),
    (64, 48, 16, 1, "shared_a"),
    (1, 48, 16, 1, "shared_a"),
    (256, 48, 16, 4, "signed"),
    (150, 1, 4, 1, "positive"),
    (13, 1, 4, 1, "signed"),
    (9, 2, 5, 3, "signed"),
    (16, 4, 3, 1, "signed"),
    (5, 1, 8, 8, "signed"),
    (17, 1, 4, 2, "e200"),
    (25, 2, 8, 3, "e200"),
    (63, 2, 16, 2, "signed"),
    (65, 3, 16, 1, "shared_a"),
    (70, 1, 24, 3, "signed"),
    (100, 3, 32, 2, "shared_a"),
]


@pytest.mark.parametrize("tlen,g,d,m,kind", CASES)
def test_passes_match_float64_and_jax(tlen, g, d, m, kind):
    check(distances(tlen, g, d, m, kind, seed=tlen + d))


@pytest.mark.parametrize("fixed,seed,b_scale", [(True, 4, 1.0), (True, 4, 0.0),
                                                 (False, 1, 1e-6), (False, 1, 0.0)])
def test_products_in_f64_keep_rank_deficient_chains(fixed, seed, b_scale):
    """0.3 N(0,1) steps over T = 256 turn the state nearly rank-1, and a
    small (or exactly zero) B barely lifts it: the stitch cancels against
    the chunks' products.  With those products in f64 the kernel stays
    within twice the walk (values over each column's largest); in f32 these
    seeds land at 1.2x to 2.9x the bar."""
    tlen, d, m = 256, 16, 2
    rng = np.random.default_rng(seed)
    a = _planes(rng.normal(size=(1 if fixed else tlen, 1, d, d)) * 0.3)
    b = _planes(rng.normal(size=(tlen, 1, d, m)) * b_scale)
    x0 = _planes(rng.normal(size=(1, d, m)))
    shape = (tlen, 1, d, d)
    got = _torch(kernel(*a, *b, *x0, fixed=fixed))
    walk = _torch(kernel(*a, *b, *x0, fixed=fixed, ell=tlen))
    plain = matrix_scan_ref(_torch(a, shape), _torch(b), _torch(x0))
    f64 = torch.float64
    exact = matrix_scan_ref(_torch(a, shape, f64), _torch(b, None, f64), _torch(x0, None, f64))
    scale = exact.log_abs.amax(-2, keepdim=True).expand_as(exact.log_abs)
    check({"kernel": goom_dist(got, exact, scale), "walk": goom_dist(walk, exact, scale),
           "plain": goom_dist(plain, exact, scale)})


def test_zero_bias_and_zero_state_stay_exact_zeros():
    """x0 = None and B all exact zeros: every state is (-inf, +1), through
    the LSE's zero path, never NaN."""
    a, b, _, fixed = operands(40, 2, 16, 2, "shared_a")
    zero = (np.full_like(b[0], -np.inf), np.ones_like(b[1]))
    out_l, out_s = kernel(*a, *zero, None, None, fixed=fixed)
    assert (out_l == -np.inf).all() and (out_s == 1.0).all()


@pytest.mark.parametrize("d", [3, 16, 24, 32, 64, 128])
def test_chunk_len_is_a_function_of_t_and_d(d):
    """L is fixed by (T, d): the same for every G, m and call.  T itself
    (one chunk, the walk) at T <= WALK_MAX_T and above d = 32 (the block
    kernel walks); else a power of two, the least with L^2 >= T whose
    K = ceil(T / L) chunk warps fit the block (16 at d <= 16, 4 at d <= 32)."""
    kmax = 16 if d <= 16 else 4

    def fits(ell, tlen):
        return ell * ell >= tlen and -(-tlen // ell) <= kmax

    assert with_b_chunk_len(1, d) == 1
    for tlen in (1, 2, 16, 24, 25, 63, 64, 65, 100, 256, 1000, 2001, 4097):
        ell = with_b_chunk_len(tlen, d)
        assert ell == with_b_chunk_len(tlen, d)
        if d > 32 or tlen <= WALK_MAX_T:
            assert ell == tlen
            continue
        assert ell & (ell - 1) == 0 and fits(ell, tlen) and not fits(ell // 2, tlen)
    if d <= 16:
        assert with_b_chunk_len(64, d) == 8 and with_b_chunk_len(256, d) == 16
