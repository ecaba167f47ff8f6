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
