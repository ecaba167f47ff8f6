"""The paper's experiments 1 and 2 in the port, against the JAX package.

* Chains (``core/chains.py``): the properties of ``tests/test_scan.py`` and
  ``benchmarks/run.py``'s fig. 1: floats fail, GOOMs run on, and the
  parallel chain (``engine.cumulative_lmme``) agrees with the sequential one
  (a loop of ``engine.lmme``).
* Lyapunov (``core/lyapunov.py``): the four estimators run on JAX's own
  Jacobians (handed over as numpy) and agree with JAX's estimators to 1e-4.
  Chaotic rollouts part ways between two frameworks within a few hundred
  steps, so the port's own rollout is held to JAX's step function and
  Jacobian on its first 50 steps only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jax_engine
from repro.core import lyapunov as jly
from repro_torch.core import chains, engine, lyapunov
from repro_torch.core.goom import from_goom, to_goom

torch.set_num_threads(2)

N_STEPS = 1024
SYSTEMS = sorted(lyapunov.SYSTEMS)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# experiment 1: chains
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [8, 32])
def test_float_chain_fails_where_the_goom_chain_runs_on(d):
    res = chains.float_chain_survival(_gen(), d, 20_000, device="cpu")
    assert 0 < res.steps_survived < 200  # overflows f32 within ~88/(0.5 ln d) steps
    engine.reset_calls()
    g = chains.goom_chain(_gen(), d, 400, device="cpu")
    assert engine.calls["lmme"] == 400
    assert g.steps_survived == 400
    assert g.final_log_norm > 150.0  # far beyond f32's ~88


def test_parallel_chain_matches_the_sequential_loop():
    engine.reset_calls()
    states = chains.goom_chain_parallel(_gen(3), 8, 300, device="cpu")
    assert engine.calls["cumulative_lmme"] == 1 and states.shape == (301, 8, 8)
    seq = chains.goom_chain(_gen(3), 8, 300, device="cpu")
    par = float(chains.goom_log_norm(states[-1]))
    assert abs(par - seq.final_log_norm) <= 1e-5 * abs(seq.final_log_norm)
    assert torch.isfinite(states.log_abs).all()


def test_cumulative_lmme_matches_float_cumprod():
    mats = torch.randn(10, 3, 3, generator=_gen(1))
    got = from_goom(engine.cumulative_lmme(to_goom(mats)))
    p = torch.eye(3)
    for i in range(10):
        p = mats[i] @ p
        np.testing.assert_allclose(got[i].numpy(), p.numpy(), rtol=5e-3, atol=5e-3)


def test_chain_matrices_are_seeded():
    a = chains.chain_matrices(_gen(5), 4, 6, device="cpu")
    b = chains.chain_matrices(_gen(5), 4, 6, device="cpu")
    assert a.shape == (7, 4, 4) and torch.equal(a, b)


def test_goom_log_norm_is_the_frobenius_norm():
    x = torch.randn(5, 5, generator=_gen(2)) * 1e3
    got = float(chains.goom_log_norm(to_goom(x)))
    assert got == pytest.approx(float(torch.log(torch.linalg.norm(x))), rel=1e-6)


# ---------------------------------------------------------------------------
# experiment 2: Lyapunov exponents
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_jacobians():
    """JAX's own rollouts: {name: (jacobians as numpy, dt)}."""
    out = {}
    for name in SYSTEMS:
        sys_ = jly.SYSTEMS[name]
        _, js = jly.trajectory_and_jacobians(sys_, N_STEPS)
        out[name] = (np.asarray(js), sys_.dt)
    return out


def _jax_estimate(estimator, js, dt):
    fns = {
        "spectrum_sequential": lambda j: jly.spectrum_sequential(j, dt),
        "lle_sequential": lambda j: jly.lle_sequential(j, dt),
        "spectrum_parallel": lambda j: jly.spectrum_parallel(j, dt, chunk_size=256),
        "lle_parallel": lambda j: jly.lle_parallel(j, dt),
    }
    with jax_engine.use_backend("xla_reference"):
        return np.asarray(jax.jit(fns[estimator])(jnp.asarray(js)))


def _port_estimate(estimator, js, dt):
    j = torch.tensor(js)
    if estimator == "spectrum_parallel":
        return lyapunov.spectrum_parallel(j, dt, chunk_size=256).numpy()
    return getattr(lyapunov, estimator)(j, dt).numpy()


@pytest.mark.parametrize("estimator", ["spectrum_sequential", "lle_sequential",
                                       "spectrum_parallel", "lle_parallel"])
@pytest.mark.parametrize("name", SYSTEMS)
def test_estimators_match_jax_on_jax_jacobians(jax_jacobians, name, estimator):
    js, dt = jax_jacobians[name]
    engine.reset_calls()
    got = _port_estimate(estimator, js, dt)
    if estimator == "spectrum_parallel":  # 4 chunks of 256, one reset scan each
        assert engine.calls["selective_reset_scan"] == 4 and engine.calls["lmme"] > 0
    if estimator == "lle_parallel":
        assert engine.calls["cumulative_lmme"] == 1
    np.testing.assert_allclose(got, _jax_estimate(estimator, js, dt), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", SYSTEMS)
def test_rollout_follows_jax_step_and_jacobian(name):
    """The port's own rollout, first 50 steps: each state is JAX's step of
    the one before, and each Jacobian is JAX's ``jacfwd`` there."""
    sys_j = jly.SYSTEMS[name]
    xs, js = lyapunov.trajectory_and_jacobians(lyapunov.SYSTEMS[name], 50, device="cpu")
    assert xs.shape == (50, sys_j.dim) and js.shape == (50, sys_j.dim, sys_j.dim)
    assert xs.dtype == js.dtype == torch.float32  # the kernels take f32 only
    x = xs.numpy()
    step = jax.jit(jax.vmap(sys_j.step))
    jac = jax.jit(jax.vmap(jax.jacfwd(sys_j.step)))
    np.testing.assert_allclose(x[1:], np.asarray(step(jnp.asarray(x[:-1]))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(js.numpy()[1:].reshape(49, -1),
                               np.asarray(jac(jnp.asarray(x[:-1]))).reshape(49, -1),
                               rtol=1e-5, atol=1e-5)


def test_linear_system_exact_spectrum_and_lle():
    d = torch.tensor([2.0, 0.5, 0.1])
    js = torch.diag(d).expand(256, 3, 3)
    want = torch.log(d).numpy()
    np.testing.assert_allclose(lyapunov.spectrum_sequential(js, 1.0).numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(lyapunov.spectrum_parallel(js, 1.0).numpy(), want,
                               rtol=1e-3, atol=1e-3)
    js2 = torch.diag(torch.tensor([3.0, 0.2])).expand(128, 2, 2)
    assert float(lyapunov.lle_parallel(js2, 1.0)) == pytest.approx(np.log(3.0), rel=1e-2)


def test_non_divisible_length_is_padded_not_rejected():
    d = torch.tensor([2.0, 0.5, 0.1])
    js = torch.diag(d).expand(300, 3, 3)  # 300 = 2*128 + 44
    got = lyapunov.spectrum_parallel(js, 1.0, chunk_size=128)
    np.testing.assert_allclose(got.numpy(), torch.log(d).numpy(), rtol=1e-3, atol=1e-3)


def test_paper_literal_single_scan_recovers_lambda1(jax_jacobians):
    js, dt = jax_jacobians["lorenz63"]
    j = torch.tensor(js)
    seq = lyapunov.spectrum_sequential(j, dt)
    par = lyapunov.spectrum_parallel(j, dt, chunk_size=None)
    assert float(par[0]) == pytest.approx(float(seq[0]), rel=1e-3, abs=1e-3)
