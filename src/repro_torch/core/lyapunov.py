"""Experiment 2 (paper §4.2): parallel estimation of Lyapunov exponents.

Counterpart of ``repro/core/lyapunov.py``: the same four in-repo systems with
their literature spectra, Jacobians from ``torch.func.jacfwd`` of the step
function, and the estimators:

  * ``spectrum_sequential`` — the standard iterative-QR method (eq. 19–20);
  * ``lle_sequential``      — norm growth of one vector (eq. 21–22);
  * ``spectrum_parallel``   — the paper's parallel algorithm (§4.2.1 groups
                              a–d) with selective resetting over GOOMs;
  * ``lle_parallel``        — the largest exponent via PSCAN(LMME) (eq. 24).

The parallel estimators go through the engine: ``selective_reset_scan``
(its products on the LMME kernel) and ``cumulative_lmme`` (the zero-B
matrix-scan kernel).  QR stays ``torch.linalg.qr``, outside any kernel, as
the JAX package leaves it to ``jnp.linalg.qr``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels.dispatch import resolve_device
from . import engine
from .goom import Goom, from_goom, safe_abs, safe_log, to_goom
from .ops import goom_lse, goom_normalize_cols
from .scan import colinearity_select, orthonormal_reset

__all__ = [
    "DynamicalSystem",
    "SYSTEMS",
    "trajectory_and_jacobians",
    "spectrum_sequential",
    "spectrum_parallel",
    "lle_parallel",
    "lle_sequential",
]


# ---------------------------------------------------------------------------
# dynamical systems (discrete step functions x_{t+1} = f(x_t))
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DynamicalSystem:
    name: str
    step: Callable[[torch.Tensor], torch.Tensor]  # one discrete time step
    dim: int
    dt: float  # time per discrete step (1.0 for maps)
    x0: Tuple[float, ...]
    ref_spectrum: Tuple[float, ...]  # literature values (per unit time)
    transient: int = 500  # steps to discard before measuring


def _rk4(f, x, dt):
    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _lorenz_rhs(x, sigma=10.0, rho=28.0, beta=8.0 / 3.0):
    return torch.stack([sigma * (x[1] - x[0]),
                        x[0] * (rho - x[2]) - x[1],
                        x[0] * x[1] - beta * x[2]])


def _rossler_rhs(x, a=0.2, b=0.2, c=5.7):
    return torch.stack([-x[1] - x[2], x[0] + a * x[1], b + x[2] * (x[0] - c)])


def _henon_step(x, a=1.4, b=0.3):
    return torch.stack([1.0 - a * x[0] ** 2 + x[1], b * x[0]])


def _logistic_step(x, r=4.0):
    return r * x * (1.0 - x)


SYSTEMS: Dict[str, DynamicalSystem] = {
    "lorenz63": DynamicalSystem(
        "lorenz63", partial(_rk4, _lorenz_rhs, dt=0.01), 3, 0.01,
        (1.0, 1.0, 1.0), (0.9056, 0.0, -14.5723),  # Viswanath 1998 / Sprott 2003
    ),
    "rossler": DynamicalSystem(
        "rossler", partial(_rk4, _rossler_rhs, dt=0.05), 3, 0.05,
        (1.0, 1.0, 1.0), (0.0714, 0.0, -5.3943),  # Sprott 2003
        transient=2000,
    ),
    "henon": DynamicalSystem(
        "henon", _henon_step, 2, 1.0, (0.1, 0.1), (0.4192, -1.6229)
    ),
    "logistic": DynamicalSystem(
        "logistic", _logistic_step, 1, 1.0, (0.4,), (0.6931,),  # ln 2 at r=4
    ),
}


def trajectory_and_jacobians(system: DynamicalSystem, n_steps: int, *,
                             device=None, dtype=torch.float32):
    """Roll out the system after its transient; returns (trajectory (T, dim),
    per-step Jacobians (T, dim, dim)).  The rollout is a sequential loop of
    tiny steps on no kernel path: on a card each step is a few launches, so
    a caller may prefer ``device="cpu"`` and move the Jacobians over."""
    dev = resolve_device(device)
    step = system.step
    x = torch.tensor(system.x0, dtype=dtype, device=dev).reshape(system.dim)
    with torch.no_grad():
        for _ in range(system.transient):
            x = step(x)
        before = []
        for _ in range(n_steps):
            before.append(x)
            x = step(x)
        x_in = torch.stack(before)
        # the Jacobian at each state the step leaves, in one batched call
        # (forward-mode through the Python-float constants comes back f64)
        js = torch.vmap(torch.func.jacfwd(step))(x_in).to(dtype)
    return torch.cat([x_in[1:], x[None]]), js.reshape(n_steps, system.dim, system.dim)


# ---------------------------------------------------------------------------
# sequential baselines
# ---------------------------------------------------------------------------
def spectrum_sequential(jacobians: torch.Tensor, dt: float) -> torch.Tensor:
    """Standard iterative-QR estimator (paper eq. 19–20)."""
    d = jacobians.shape[-1]
    q = torch.eye(d, dtype=jacobians.dtype, device=jacobians.device)
    logs = []
    for j in jacobians:
        q, r = torch.linalg.qr(j @ q)
        logs.append(safe_log(safe_abs(torch.diagonal(r))))
    return torch.stack(logs).mean(0) / dt


def lle_sequential(jacobians: torch.Tensor, dt: float) -> torch.Tensor:
    """Norm-growth estimator for the largest exponent (eq. 21–22)."""
    d = jacobians.shape[-1]
    u = torch.ones(d, dtype=jacobians.dtype, device=jacobians.device) / d ** 0.5
    logs = []
    for j in jacobians:
        s = j @ u
        n = torch.linalg.norm(s)
        u = s / n
        logs.append(safe_log(n))
    return torch.stack(logs).mean() / dt


# ---------------------------------------------------------------------------
# the paper's parallel algorithm (§4.2.1)
# ---------------------------------------------------------------------------
def _log_diag_r(s: torch.Tensor) -> torch.Tensor:
    _, r = torch.linalg.qr(s)
    return safe_log(safe_abs(torch.diagonal(r, dim1=-2, dim2=-1)))


def spectrum_parallel(jacobians: torch.Tensor, dt: float, *,
                      colinearity_threshold: float = 0.99,
                      chunk_size: Optional[int] = 128) -> torch.Tensor:
    """Full spectrum, time-parallel, with selective resetting over GOOMs.

    Groups (a)–(d) of §4.2.1: (a) prefix-scan all input states over GOOMs,
    resetting near-colinear interim states to an orthonormal basis of their
    span; (b) QR every log-normalized, exp'd state → Q_{t-1}; (c) S*_t =
    J_t Q_{t-1}; (d) QR every S*_t and average log |diag R_t|.

    ``chunk_size=None`` is the paper-literal single scan.  With ``chunk_size=K``
    the parallel scan runs inside chunks of K and the orthonormal basis is
    carried from chunk to chunk (see the JAX package's docstring for why).
    A trailing partial chunk is padded with identity Jacobians and masked
    out of the mean.
    """
    t, d = jacobians.shape[0], jacobians.shape[-1]
    dev, dtype = jacobians.device, jacobians.dtype
    select = colinearity_select(colinearity_threshold)
    reset = orthonormal_reset()
    eye = torch.eye(d, dtype=dtype, device=dev)

    def states_q(elems: torch.Tensor) -> torch.Tensor:
        states, _ = engine.selective_reset_scan(to_goom(elems), select, reset)
        q, _ = torch.linalg.qr(from_goom(goom_normalize_cols(states)))
        return q

    if chunk_size is None or chunk_size >= t:
        # elements [S_0, J_1, ..., J_{T-1}] (paper App. C folds X_0 in)
        q = states_q(torch.cat([eye[None], jacobians[:-1]]))
        return _log_diag_r(jacobians @ q).mean(0) / dt

    pad = (-t) % chunk_size
    if pad:
        jacobians = torch.cat([jacobians, eye.expand(pad, d, d)])
    q_in, total = eye, torch.zeros(d, dtype=dtype, device=dev)
    for k, js in enumerate(jacobians.split(chunk_size)):
        q = states_q(torch.cat([(js[0] @ q_in)[None], js[1:]]))
        q_prev = torch.cat([q_in[None], q[:-1]])
        logs = _log_diag_r(js @ q_prev)
        valid = max(0, min(chunk_size, t - k * chunk_size))
        total = total + logs[:valid].sum(0)
        q_in = q[-1]
    return total / t / dt


def lle_parallel(jacobians: torch.Tensor, dt: float) -> torch.Tensor:
    """Largest exponent via PSCAN(LMME) (paper eq. 24 / App. B)."""
    t, d = jacobians.shape[0], jacobians.shape[-1]
    # u_0 as the first column of a d x d matrix, so the scan elements share
    # one shape; the products keep column 0 == s_t (other columns are 0)
    u0 = torch.zeros(d, d, dtype=jacobians.dtype, device=jacobians.device)
    u0[:, 0] = 1.0 / d ** 0.5
    states = engine.cumulative_lmme(to_goom(torch.cat([u0[None], jacobians])))
    final = states[-1][..., :, 0]  # s_T
    doubled = Goom(2.0 * final.log_abs, torch.ones_like(final.sign))
    return goom_lse(doubled, dim=-1).log_abs / (2.0 * dt * t)
