"""LMME of the PyTorch port against the JAX package, and the port's backend
dispatch.

The port's plain LMME (``lmme_reference``, the CUDA kernel's plain version)
and its exact oracle (``lmme_naive``) are held against JAX's ``lmme_naive``,
``lmme_reference`` and the Pallas kernel in interpret mode, on shared numpy
inputs: tiny shapes, A broadcast over batch dims, rows spread to e±200, and
exact-zero (-inf) rows and columns.  The CUDA kernel itself runs only on a
card: see ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.goom import Goom as JGoom
from repro.core.ops import lmme_naive as j_naive
from repro.core.ops import lmme_reference as j_reference
from repro.kernels.lmme.ops import lmme_pallas
from repro_torch.core import engine
from repro_torch.core.goom import Goom
from repro_torch.core.ops import lmme_naive, lmme_reference
from repro_torch.kernels import dispatch
from repro_torch.kernels.goom_scan import diagonal_scan_cuda, matrix_scan_cuda
from repro_torch.kernels.lmme import lmme_cuda, lmme_ref
from torch_parity import assert_goom_close, goom_planes, lmme_abs_scale, n, t

torch.set_num_threads(2)

# (a batch + (n, d), b batch + (d, m)); A broadcast as on the serving path
CASES = {
    "square": ((8, 8), (8, 8)),
    "rect": ((16, 32), (32, 8)),
    "matvec": ((1, 40), (40, 1)),
    "bcast_a": ((3, 8, 8), (5, 2, 3, 8, 1)),   # (H,d,d) ∘ (S,B,H,d,1)
    "bcast_both": ((2, 1, 6, 5), (4, 5, 3)),
}


def _operands(case, seed=0, spread=0.0, zero_rows=False):
    sa, sb = CASES[case]
    rng = np.random.default_rng(seed)
    a = goom_planes(rng, sa, spread=spread, zero_rows=zero_rows)
    b = goom_planes(rng, sb, spread=spread, along="col")
    if zero_rows:  # and one all-zero column of b
        b[0][..., :, 0] = -np.inf
        b[1][..., :, 0] = 1.0
    return a, b


def _close(got, want, a, b):
    assert_goom_close(*got, *want, scale_log=lmme_abs_scale(a[0], b[0]))


def _port(fn, a, b):
    out = fn(Goom(t(a[0]), t(a[1])), Goom(t(b[0]), t(b[1])))
    return out.log_abs, out.sign


def _jax(fn, a, b, **kw):
    out = fn(JGoom(jnp.asarray(a[0]), jnp.asarray(a[1])),
             JGoom(jnp.asarray(b[0]), jnp.asarray(b[1])), **kw)
    return out.log_abs, out.sign


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("spread", [0.0, 200.0])
def test_plain_lmme_matches_jax_naive_and_reference(case, spread):
    a, b = _operands(case, seed=1, spread=spread)
    got = _port(lmme_reference, a, b)
    _close(got, _jax(j_naive, a, b), a, b)
    # same algorithm as JAX's compromise LMME: tight agreement
    want = _jax(j_reference, a, b)
    np.testing.assert_allclose(n(got[0]), n(want[0]), rtol=1e-5, atol=1e-4)
    if spread:
        assert np.abs(n(got[0])).max() > 150.0  # the range was reached


@pytest.mark.parametrize("case", ["square", "bcast_a"])
def test_plain_lmme_matches_pallas_interpret_e200(case):
    a, b = _operands(case, seed=2, spread=200.0)
    want = _jax(lmme_pallas, a, b, interpret=True)
    _close(_port(lmme_reference, a, b), want, a, b)


@pytest.mark.parametrize("case", ["square", "bcast_a"])
def test_zero_rows_and_columns_give_exact_zeros(case):
    a, b = _operands(case, seed=3, spread=200.0, zero_rows=True)
    got = _port(lmme_reference, a, b)
    assert np.all(n(got[0])[..., 0, :] == -np.inf)   # zero row of a
    assert np.all(n(got[0])[..., :, 0] == -np.inf)   # zero column of b
    assert not np.any(np.isnan(n(got[0])))
    _close(got, _jax(j_naive, a, b), a, b)


@pytest.mark.parametrize("case", ["rect", "bcast_a"])
def test_naive_oracle_matches_jax(case):
    a, b = _operands(case, seed=4, spread=50.0)
    _close(_port(lmme_naive, a, b), _jax(j_naive, a, b), a, b)


@pytest.mark.parametrize("case", ["rect", "bcast_a"])
def test_plain_lmme_gradients_match_jax(case):
    """The kernel's backward is autograd of ``lmme_reference``: its
    gradients must be JAX's, broadcast dims reduced included."""
    a, b = _operands(case, seed=5, spread=20.0)
    w = np.random.default_rng(6).normal(
        size=np.broadcast_shapes(a[0].shape[:-1] + (1,), b[0].shape[:-2] + (1, 1))[:-2]
        + (a[0].shape[-2], b[0].shape[-1])).astype(np.float32)

    def jf(al, bl):
        out = j_reference(JGoom(al, jnp.asarray(a[1])), JGoom(bl, jnp.asarray(b[1])))
        return jnp.sum(out.log_abs * w)

    jda, jdb = jax.grad(jf, argnums=(0, 1))(jnp.asarray(a[0]), jnp.asarray(b[0]))
    al, bl = t(a[0]).requires_grad_(), t(b[0]).requires_grad_()
    out = lmme_reference(Goom(al, t(a[1])), Goom(bl, t(b[1])))
    (out.log_abs * t(w)).sum().backward()
    np.testing.assert_allclose(n(al.grad), n(jda), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(bl.grad), n(jdb), rtol=1e-4, atol=1e-5)


def test_wrapper_on_cpu_tensors_runs_the_plain_version():
    a, b = _operands("bcast_a", seed=7)
    before = lmme_cuda.launches
    got = _port(lmme_cuda, a, b)
    want = lmme_ref(t(a[0]), t(a[1]), t(b[0]), t(b[1]))
    np.testing.assert_array_equal(n(got[0]), n(want[0]))
    np.testing.assert_array_equal(n(got[1]), n(want[1]))
    assert lmme_cuda.launches == before  # no kernel ran


def test_dispatch_resolution_table():
    f32, bf16 = torch.float32, torch.bfloat16
    assert dispatch.resolve_backend("auto", device_type="cpu", dtype=f32) == "torch_reference"
    assert dispatch.resolve_backend("auto", device_type="cpu", dtype=bf16) == "torch_reference"
    assert dispatch.resolve_backend("auto", device_type="cuda", dtype=f32) == "cuda"
    assert dispatch.resolve_backend("torch_reference", device_type="cuda",
                                    dtype=f32) == "torch_reference"
    with pytest.raises(TypeError):  # no silent drop to the plain version
        dispatch.resolve_backend("auto", device_type="cuda", dtype=bf16)
    with pytest.raises(ValueError):
        dispatch.resolve_backend("pallas", device_type="cuda", dtype=f32)
    assert dispatch.registered_impls() == tuple(
        (op, b) for op in ("cumulative_lmme", "diagonal_scan", "lmme", "matrix_scan")
        for b in ("cuda", "torch_reference"))
    assert dispatch.get_impl("lmme", "cuda") is lmme_cuda
    assert dispatch.get_impl("matrix_scan", "cuda") is matrix_scan_cuda
    assert dispatch.get_impl("diagonal_scan", "cuda") is diagonal_scan_cuda
    with pytest.raises(KeyError):  # the engine builds it from lmme: no entry
        dispatch.get_impl("selective_reset_scan", "cuda")


def test_engine_lmme_counts_calls_and_honours_use_backend():
    a, b = _operands("bcast_a", seed=8)
    ga, gb = Goom(t(a[0]), t(a[1])), Goom(t(b[0]), t(b[1]))
    engine.reset_calls()
    auto = engine.lmme(ga, gb)
    with engine.use_backend("cuda"):     # forced: CPU planes -> plain version
        forced = engine.lmme(ga, gb)
    with pytest.raises(ValueError):
        with engine.use_backend("pallas"):
            pass
    assert engine.calls["lmme"] == 2 and engine.current_backend() == "auto"
    np.testing.assert_array_equal(n(auto.log_abs), n(forced.log_abs))
    _close((auto.log_abs, auto.sign), _jax(j_naive, a, b), a, b)


def test_cuda_planes_of_other_dtypes_raise_before_any_launch(monkeypatch):
    """A CUDA bf16 operand must raise, not drop to the plain version.  The
    device type is faked: resolution reads only ``device.type``."""
    class _Dev:
        type = "cuda"

    class _Plane:
        device = _Dev()

    g = Goom(_Plane(), _Plane())
    monkeypatch.setattr(Goom, "dtype", property(lambda self: torch.bfloat16))
    with pytest.raises(TypeError, match="float32"):
        engine.lmme(g, g)


# ---------------------------------------------------------------------------
# the CUDA kernel's launch shapes and K order, without a card
# ---------------------------------------------------------------------------
# (a shape, b shape, batched?): chip_smoke.py's kernel-phase shapes
LAUNCH_SHAPES = [
    ((48, 16, 16), (4, 48, 16, 1), True),       # decode
    ((48, 16, 16), (1, 48, 16, 1), True),       # admit fold
    ((48, 16, 16), (64, 1, 48, 16, 1), True),   # 64-token chunk
    ((48, 16, 16), (48, 16, 16), True),         # A doubling
    ((128, 3, 3), (128, 3, 3), True),           # spectrum reset
    ((8, 8), (8, 8), True),                     # chain d=8
    ((2, 1, 6, 5), (4, 5, 3), True),            # broadcast on both sides
    ((32, 32), (32, 32), False),                # chain d=32: 1024 outputs
    ((128, 128), (128, 128), False),            # chain d=128
    ((130, 70), (70, 50), False),
    ((4, 8, 256), (4, 256, 16), False),
]


@pytest.mark.parametrize("sa,sb,batched", LAUNCH_SHAPES)
def test_launch_shape_is_picked_from_the_shape(sa, sb, batched):
    """``batched_plan`` picks the batched launch for the serving path's
    broadcast matvecs and small products, the tiled one for the rest; the
    batched plan walks A's batch with one stride and B's rows with another."""
    from repro_torch.kernels.lmme.ops import batched_plan

    a, b = torch.empty(sa), torch.empty(sb)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    nb = len(batch)
    ae, be = a.expand(batch + a.shape[-2:]), b.expand(batch + b.shape[-2:])
    plan = batched_plan(batch, ae.stride()[:nb], be.stride()[:nb], sa[-2], sa[-1], sb[-1])
    assert (plan is not None) == batched
    if plan is not None:
        (nv, *_), (nq, a_q, _, _), qb = plan
        assert nv * nq == int(np.prod(batch)) and a_q == 0
        assert 1 <= qb <= nq and qb * sa[-2] * sb[-1] <= 256


def _kernel_k_order(a_log, a_sign, b_log, b_sign, seg=64):
    """The kernel's arithmetic in numpy: exact maxima, f32 exps, chains of
    ``seg`` terms summed in k order, the chains folded left to right."""
    with np.errstate(divide="ignore"):
        mr = a_log.max(-1, keepdims=True)
        mc = b_log.max(-2, keepdims=True)
        mr, mc = np.where(np.isfinite(mr), mr, 0), np.where(np.isfinite(mc), mc, 0)
        ea = (a_sign * np.exp(a_log - mr)).astype(np.float32)
        eb = (b_sign * np.exp(b_log - mc)).astype(np.float32)
        total = None
        for k0 in range(0, a_log.shape[-1], seg):
            acc = np.zeros(ea.shape[:-1] + eb.shape[-1:], np.float32)
            for k in range(k0, min(k0 + seg, a_log.shape[-1])):
                acc = (acc + ea[..., k:k + 1] * eb[..., k:k + 1, :]).astype(np.float32)
            total = acc if total is None else (total + acc).astype(np.float32)
        out = (np.log(np.abs(total)) + mr + mc).astype(np.float32)
    return out, np.where(total >= 0, 1.0, -1.0).astype(np.float32)


@pytest.mark.parametrize("d", [16, 70, 256, 300])
def test_kernel_k_order_holds_the_plain_versions_tolerance(d):
    """The segmented K order (chains of 64, folded in order) on e±200 inputs
    with zero rows and columns agrees with the plain version and with JAX's
    reference at ``assert_goom_close``'s tolerances."""
    rng = np.random.default_rng(d)
    a = goom_planes(rng, (3, 9, d), spread=200.0, zero_rows=True)
    b = goom_planes(rng, (3, d, 5), spread=200.0, along="col")
    b[0][..., :, 0], b[1][..., :, 0] = -np.inf, 1.0
    got = _kernel_k_order(*a, *b)
    want = lmme_reference(Goom(t(a[0]), t(a[1])), Goom(t(b[0]), t(b[1])))
    jwant = j_reference(JGoom(jnp.asarray(a[0]), jnp.asarray(a[1])),
                        JGoom(jnp.asarray(b[0]), jnp.asarray(b[1])))
    scale = lmme_abs_scale(a[0], b[0])
    for w in ((want.log_abs, want.sign), (jwant.log_abs, jwant.sign)):
        assert_goom_close(*got, *w, scale_log=scale)
    assert np.all(got[0][:, 0] == -np.inf) and np.all(got[0][..., 0] == -np.inf)
