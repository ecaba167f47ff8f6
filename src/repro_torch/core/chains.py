"""Experiment 1 (paper §4.1, Fig. 1): long chains of random matrix products.

``S_t = A_t S_{t-1}`` with ``A_t ~ N(0,1)^{d x d}``.  Over floats the chain
compounds magnitudes like ``sqrt(d)^t`` and overflows within ~``log(MAX)/
(0.5 log d)`` steps; over GOOMs the log-magnitude grows linearly and the
chain runs for as long as the log fits the component float.

Counterpart of ``repro/core/chains.py``: a ``torch.Generator`` (on the
device) and a device take the place of the JAX key; the device defaults to
``cuda``, like every entry point of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.dispatch import resolve_device
from . import engine
from .goom import Goom, safe_log, to_goom

__all__ = ["ChainResult", "chain_matrices", "goom_log_norm", "float_chain_survival",
           "goom_chain", "goom_chain_parallel"]


class ChainResult(NamedTuple):
    steps_survived: int      # first failing step (== n_steps if none failed)
    final_log_norm: float    # log Frobenius norm of the final state


def _is_catastrophic(x: torch.Tensor) -> bool:
    """Non-finite anywhere, or total collapse to zero."""
    return bool(~torch.isfinite(x).all() | (x == 0).all())


def goom_log_norm(s: Goom) -> torch.Tensor:
    """log Frobenius norm straight from log space (no overflow possible)."""
    m = s.log_abs.amax()
    # the exp is dominated by the subtracted max (2*(x - m) <= 0); goomcheck: disable=GC202
    return 0.5 * safe_log(torch.exp(2.0 * (s.log_abs - m)).sum()) + m


def float_chain_survival(gen: torch.Generator, d: int, n_steps: int,
                         dtype=torch.float32, *, device=None) -> ChainResult:
    """Run the chain over plain floats; report how many steps survive.

    The first failing step ends the run: the JAX version carries the chain
    on after it without changing the count."""
    dev = resolve_device(device)
    s = torch.randn((d, d), generator=gen, device=dev, dtype=dtype)
    steps = 0
    for _ in range(n_steps):
        s_new = torch.randn((d, d), generator=gen, device=dev, dtype=dtype) @ s
        if _is_catastrophic(s_new):
            break
        s, steps = s_new, steps + 1
    fro = torch.linalg.norm(s.float())
    return ChainResult(steps, float(safe_log(fro)))


def chain_matrices(gen: torch.Generator, d: int, n_steps: int, dtype=torch.float32,
                   *, device=None) -> torch.Tensor:
    """The chain's (n_steps + 1, d, d) floats: S_0, then A_1 ... A_n."""
    dev = resolve_device(device)
    return torch.randn((n_steps + 1, d, d), generator=gen, device=dev, dtype=dtype)


def goom_chain(gen: torch.Generator, d: int, n_steps: int, dtype=torch.float32,
               *, device=None) -> ChainResult:
    """Run the chain over GOOMs sequentially: one ``engine.lmme`` per step."""
    mats = chain_matrices(gen, d, n_steps, dtype, device=device)
    s = to_goom(mats[0])
    for a in mats[1:]:
        s = engine.lmme(to_goom(a), s)
    # catastrophic error in log space is NaN or +inf (-inf is an exact zero)
    ok = not bool((torch.isnan(s.log_abs) | torch.isposinf(s.log_abs)).any())
    return ChainResult(n_steps if ok else 0, float(goom_log_norm(s)))


def goom_chain_parallel(gen: torch.Generator, d: int, n_steps: int,
                        dtype=torch.float32, *, device=None) -> Goom:
    """All prefix states S_0 ... S_n in parallel via ``engine.cumulative_lmme``
    (paper eq. 24's machinery); on the card the zero-B matrix-scan kernel."""
    return engine.cumulative_lmme(to_goom(chain_matrices(gen, d, n_steps, dtype,
                                                         device=device)))
