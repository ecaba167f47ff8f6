"""Mamba (selective SSM), Jamba's recurrent block, with a GOOM scan.

Counterpart of ``repro/models/ssm.py`` (``segment_states``, ``MambaCfg``,
``mamba_apply``, ``mamba_init_state``).  The block reduces to a diagonal
linear recurrence with data-dependent decay, ``h_t = a_t ⊙ h_{t-1} + b_t``
with ``log a_t = Δ_t·A`` already in log space, so the GOOM form is exact:
no exp/log round trip of the decay and no clamp.  Every chunk of the
sequence is one ``engine.diagonal_scan_carry`` call, on the card one launch
of the CUDA diagonal-scan kernel.

Numerics kept from the JAX package: the conv tail and the SSM state are
f32; Δ goes through softplus in f32; A = -exp(a_log); chunks of
L = min(chunk, S) are identity-padded (Δ = 0: log-decay 0 and zero input).
There is no sequence sharding in the port, so the full-sequence branch of
the JAX code does not exist here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import MambaCfg
from ..core import engine
from ..core.goom import Goom, from_goom, nonzero_sign, safe_abs, safe_log
from .common import Dense, normal_param

__all__ = ["MambaCfg", "Mamba", "segment_states", "mamba_init_state"]


def segment_states(log_a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All states of h_t = exp(log_a_t)·h_{t-1} + b_t within one chunk.

    log_a, b (L, ...); h0 (...).  The decays are log-native (sign +1); the
    inputs and the state enter through safe log and leave through
    ``from_goom``.  Returns (states (L, ...), final state (...))."""
    a_g = Goom(log_a, torch.ones_like(log_a))
    b_g = Goom(safe_log(safe_abs(b)), nonzero_sign(b))
    x0_g = Goom(safe_log(safe_abs(h0)), nonzero_sign(h0))
    states_g, carry_g = engine.diagonal_scan_carry(a_g, b_g, x0_g)
    return from_goom(states_g), from_goom(carry_g)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: max(x, 0) + log1p(exp(-|x|))."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


class Mamba(nn.Module):
    """One Mamba mixer; parameter names follow the JAX param tree."""

    def __init__(self, cfg: MambaCfg, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d, di, n, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.rank
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.in_proj = Dense(d, (2 * di,), **kw)
        self.conv_w = normal_param((cfg.d_conv, di), 0.02, **kw)
        self.conv_b = nn.Parameter(torch.zeros(di, device=device, dtype=dtype))
        self.x_proj = Dense(di, (r + 2 * n,), **kw)
        self.dt_proj = Dense(r, (di,), **kw)
        # Δ's bias: softplus⁻¹ of a log-uniform draw in [1e-3, 1e-1]
        u = torch.rand(di, generator=generator, device=device)
        dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        self.dt_proj.b = nn.Parameter(torch.log(torch.expm1(dt0)).to(dtype))
        # S4D-real init: A[c, s] = -(s + 1)
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        self.a_log = nn.Parameter(torch.log(a).expand(di, n).to(dtype).clone())
        self.d_skip = nn.Parameter(torch.ones(di, device=device, dtype=dtype))
        self.out_proj = Dense(di, (d,), **kw)

    def forward(self, x: torch.Tensor, *, state: Optional[Dict[str, torch.Tensor]] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
        """x (B, S, d) → (out (B, S, d), new state or None)."""
        cfg, cd = self.cfg, compute_dtype
        b, s, _ = x.shape
        r, n, k = cfg.rank, cfg.d_state, cfg.d_conv

        xi, z = self.in_proj(x, compute_dtype=cd).chunk(2, dim=-1)   # (B,S,di)

        # depthwise causal conv over time, kernel d_conv
        if state is not None:
            conv_in = torch.cat([state["conv"].to(cd), xi], dim=1)
            ci = conv_in
        else:
            conv_in = xi
            ci = F.pad(xi, (0, 0, k - 1, 0))
        w = self.conv_w.to(cd)
        xconv = sum(ci[:, i:i + s] * w[i] for i in range(k)) + self.conv_b.to(cd)
        xc = F.silu(xconv)

        # input-dependent Δ, B, C
        dbc = self.x_proj(xc, compute_dtype=cd).float()
        dt_low, b_in, c_in = dbc.split([r, n, n], dim=-1)
        dt = _softplus(dt_low @ self.dt_proj.w.float() + self.dt_proj.b.float())
        a = -torch.exp(self.a_log.float())                           # (di, n)
        h = (torch.zeros(b, cfg.d_inner, n, device=x.device) if state is None
             else state["ssm"])

        L = min(cfg.chunk, s)
        pad = -s % L
        dtx = dt * xc.float()
        if pad:
            dt, dtx, b_in, c_in = (F.pad(t, (0, 0, 0, pad)) for t in (dt, dtx, b_in, c_in))
        ys = []
        for c0 in range(0, s + pad, L):
            sl = slice(c0, c0 + L)
            la = dt[:, sl, :, None] * a                             # (B,L,di,n)
            bb = dtx[:, sl, :, None] * b_in[:, sl, None, :]         # (B,L,di,n)
            states, h = segment_states(la.transpose(0, 1), bb.transpose(0, 1), h)
            ys.append(torch.einsum("lbdn,bln->bld", states, c_in[:, sl]))
        y = torch.cat(ys, dim=1)[:, :s]

        y = y + xc.float() * self.d_skip.float()
        y = y.to(cd) * F.silu(z)
        out = self.out_proj(y, compute_dtype=cd)

        new_state = None
        if state is not None:
            new_state = {"conv": conv_in[:, -(k - 1):].float(), "ssm": h}
        return out, new_state


def mamba_init_state(batch: int, cfg: MambaCfg, *, device) -> Dict[str, torch.Tensor]:
    """Zero conv tail (B, d_conv-1, d_inner) and SSM state (B, d_inner,
    d_state), both f32: the conv tail re-enters the conv at every chunk
    boundary, and a bf16 round trip there is where chunked prefill would
    part from the full-sequence scan."""
    return {
        "conv": torch.zeros(batch, cfg.d_conv - 1, cfg.d_inner, device=device),
        "ssm": torch.zeros(batch, cfg.d_inner, cfg.d_state, device=device),
    }
