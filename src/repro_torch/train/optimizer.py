"""Optimizers without ``torch.optim``: AdamW, Lion, learning-rate schedules
and the global-norm clip, as ``repro/train/optimizer.py`` computes them.

``torch.optim.AdamW`` puts eps and the decay elsewhere (eps inside the bias
correction, decay as a separate multiply before the step), so the update is
written out here, each formula the JAX package's in f32:

    mu ← b1·mu + (1-b1)·g          nu ← b2·nu + (1-b2)·g²
    Δ  = (mu/c1) / (sqrt(nu/c2) + eps) [+ wd·p]    p ← p - lr·Δ

with c_i = 1 - b_i^step in f32, the step counted from 1 and lr = schedule(step).
A state holds f32 moments keyed like the parameters and the step as an int.
Parameters, gradients and moments are dicts keyed by the port's parameter
names, updated in place with ``torch._foreach_*`` (a few launches for all
leaves instead of a dozen a leaf).  DTensor parameters (``sharding.
distribute_model``) have moments laid out as they are, and the update,
elementwise, runs on each rank's blocks; the clip's norm sums over shards.

The decay mask is JAX's: a leaf decays unless its lower-cased JAX tree path
(``convert.jax_path``, never the port's own name) holds one of
``no_decay_substrings``.  ``compress_int8`` / ``decompress_int8`` are the
JAX package's symmetric per-tensor int8 rounding of gradients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import LMConfig
from .. import convert
from ..sharding.rules import is_dtensor

Schedule = Callable[[int], float]
NO_DECAY = ("norm", "bias", "scale", "mu", "bonus")

__all__ = ["AdamW", "Lion", "cosine_schedule", "constant_schedule",
           "global_norm", "clip_by_global_norm", "compress_int8", "decompress_int8",
           "NO_DECAY"]


# ---------------------------------------------------------------------------
# LR schedules: a step → an f32 value, returned as a Python float
# ---------------------------------------------------------------------------
def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_fraction: float = 0.1) -> Schedule:
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``final_fraction·peak_lr`` at ``total_steps``; computed in f32."""
    f = np.float32
    peak, final = f(peak_lr), f(final_fraction)

    def schedule(step: int) -> float:
        step = f(step)
        if step < warmup_steps:
            return float(peak * step / f(max(warmup_steps, 1)))
        t = (step - f(warmup_steps)) / f(max(total_steps - warmup_steps, 1))
        t = np.clip(t, f(0.0), f(1.0))
        return float(peak * (final + (f(1.0) - final) * f(0.5)
                             * (f(1.0) + np.cos(f(math.pi) * t))))

    return schedule


def constant_schedule(lr: float) -> Schedule:
    value = float(np.float32(lr))
    return lambda step: value


# ---------------------------------------------------------------------------
# gradient transforms
# ---------------------------------------------------------------------------
def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's block on this rank (its storage: in-place updates reach
    the DTensor), a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in f32 (a 0-d tensor).
    DTensors' sums of squares are reduced over their shards at once
    (``_laid_sum_of_squares``): every rank gets the whole norm."""
    plain = [x.float() for x in tensors if not is_dtensor(x)]
    laid = [x for x in tensors if is_dtensor(x)]
    total = (torch.stack(torch._foreach_norm(plain)).square().sum() if plain
             else torch.zeros((), device=_local(tensors[0]).device))
    if laid:
        total = total + _laid_sum_of_squares(laid)
    return total.sqrt()


def _laid_sum_of_squares(laid: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of squares of every entry of DTensors on one mesh, in one
    reduction over the mesh dims any of them is sharded on: each rank sums
    its blocks' squares, a block held alike by the ranks of such a dim
    (``Replicate`` there) counted once over them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = laid[0].device_mesh
    laid = [x.redistribute(mesh, [Replicate() if p.is_partial() else p for p in x.placements])
            if any(p.is_partial() for p in x.placements) else x for x in laid]
    dims = sorted({i for x in laid for i, p in enumerate(x.placements) if p.is_shard()})
    held_by = torch.tensor([math.prod(mesh.size(i) for i in dims if not x.placements[i].is_shard())
                            for x in laid], dtype=torch.float32)
    squares = torch.stack(torch._foreach_norm([x.to_local().float() for x in laid])).square()
    local = (squares / held_by.to(squares.device)).sum()
    if not dims:
        return local
    return DTensor.from_local(local, mesh, [Partial() if i in dims else Replicate()
                                            for i in range(mesh.ndim)],
                              run_check=False).full_tensor()


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient by min(1, max_norm / max(norm, 1e-9)), in f32
    and in place; returns (grads, norm before the clip)."""
    norm = global_norm(list(grads.values()))
    scale = (max_norm / norm.clamp_min(1e-9)).clamp_max(1.0)
    torch._foreach_mul_([_local(g) for g in grads.values()], scale)
    return grads, norm


def compress_int8(grads: Dict[str, torch.Tensor]
                  ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Symmetric per-tensor int8 quantization (JAX ``optimizer.py:58-75``):
    each tensor as (int8 values, f32 scale), scale = max(max|x|, 1e-12) / 127
    and values round(x / scale), half to even, all in f32."""
    out = {}
    for name, x in grads.items():
        x = x.float()
        scale = x.abs().amax().clamp_min(1e-12) / 127.0
        out[name] = (torch.round(x / scale).to(torch.int8), scale)
    return out


def decompress_int8(qgrads: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
                    ) -> Dict[str, torch.Tensor]:
    """The f32 tensors of ``compress_int8``'s pairs: values times scale."""
    return {name: q.float() * scale for name, (q, scale) in qgrads.items()}


def _step_params(params: Dict[str, torch.Tensor], delta: Dict[str, torch.Tensor],
                 decay: Dict[str, bool], weight_decay: float, lr: float) -> None:
    """p ← p - lr·(Δ [+ wd·p]) in f32, in place (Δ is overwritten)."""
    params = {n: _local(p) for n, p in params.items()}
    names = list(params)
    dec = [n for n in names if decay[n]]
    if dec:
        torch._foreach_add_([delta[n] for n in dec],
                            [params[n].float() for n in dec], alpha=weight_decay)
    p32 = [params[n].float() for n in names]
    torch._foreach_add_(p32, [delta[n] for n in names], alpha=-lr)
    for n, p in zip(names, p32):
        if p is not params[n]:   # a non-f32 parameter: round back once
            params[n].copy_(p)


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    no_decay_substrings: Tuple[str, ...] = NO_DECAY

    def init(self, params: Dict[str, torch.Tensor]):
        zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        return {"mu": zeros,
                "nu": {n: torch.zeros_like(z) for n, z in zeros.items()},
                "step": 0}

    def decay_mask(self, cfg: LMConfig, names) -> Dict[str, bool]:
        """Which parameters decay: those whose lower-cased JAX tree path holds
        none of ``no_decay_substrings``."""
        def decays(name):
            path = convert.jax_path(cfg, name)[0].lower()
            return not any(sub in path for sub in self.no_decay_substrings)

        return {name: decays(name) for name in names}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state, params: Dict[str, torch.Tensor],
               decay: Dict[str, bool]):
        """One step, in place on ``params`` and ``state``'s moments; returns
        (params, state)."""
        step = state["step"] + 1
        lr = self.schedule(step)
        names = list(params)
        g = [_local(grads[n]).float() for n in names]
        mu = [_local(state["mu"][n]) for n in names]
        nu = [_local(state["nu"][n]) for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        f = np.float32
        c1 = float(f(1.0) - f(self.b1) ** f(step))
        c2 = float(f(1.0) - f(self.b2) ** f(step))
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        delta = torch._foreach_div(mu, c1)
        torch._foreach_div_(delta, denom)
        _step_params(params, dict(zip(names, delta)), decay, self.weight_decay, lr)
        return params, dict(state, step=step)


@dataclasses.dataclass(frozen=True)
class Lion:
    """Lion: p ← p - lr·(sign(b1·mu + (1-b1)·g) [+ wd·p]), then
    mu ← b2·mu + (1-b2)·g; one f32 moment."""

    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.99
    weight_decay: float = 0.1
    no_decay_substrings: Tuple[str, ...] = NO_DECAY

    def init(self, params: Dict[str, torch.Tensor]):
        return {"mu": {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in params.items()},
                "step": 0}

    decay_mask = AdamW.decay_mask   # the same path-based mask

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state, params: Dict[str, torch.Tensor],
               decay: Dict[str, bool]):
        step = state["step"] + 1
        lr = self.schedule(step)
        names = list(params)
        g = [_local(grads[n]).float() for n in names]
        mu = [_local(state["mu"][n]) for n in names]
        direction = torch._foreach_mul(mu, self.b1)
        torch._foreach_add_(direction, g, alpha=1 - self.b1)
        torch._foreach_sign_(direction)
        _step_params(params, dict(zip(names, direction)), decay, self.weight_decay, lr)
        torch._foreach_mul_(mu, self.b2)
        torch._foreach_add_(mu, g, alpha=1 - self.b2)
        return params, dict(state, step=step)
