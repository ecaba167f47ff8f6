"""State-space blocks: Mamba (selective SSM) and RWKV6 (Finch), with GOOM
scans.

Counterpart of ``repro/models/ssm.py``.

**Mamba** (``segment_states``, ``MambaCfg``, ``mamba_apply``,
``mamba_init_state``), Jamba's recurrent block, reduces to a diagonal
linear recurrence with data-dependent decay, ``h_t = a_t ⊙ h_{t-1} + b_t``
with ``log a_t = Δ_t·A`` already in log space, so the GOOM form is exact:
no exp/log round trip of the decay and no clamp.  Every chunk of the
sequence is one ``engine.diagonal_scan_carry`` call, on the card one launch
of the CUDA diagonal-scan kernel.

Numerics kept from the JAX package: the conv tail and the SSM state are
f32; Δ goes through softplus in f32; A = -exp(a_log); chunks of
L = min(chunk, S) are identity-padded (Δ = 0: log-decay 0 and zero input).
With grad enabled each chunk step is checkpointed on its own (JAX's
``@jax.checkpoint chunk_step``): its (B, L, d_inner, d_state) operands are
rebuilt in the backward.  ``MambaCfg.scan_impl="float"`` is the paper's
conventional baseline: decays exp'd up front and an associative scan of
floats, no engine call.  Under an engine mesh the ``goom`` path makes the
whole sequence one scan that the engine time-shards, as in JAX; under the
launcher's rules (``sharding.layout.time_shards``) each rank builds and
scans its own time shard.  Under rules that split ``act_mlp`` across
ranks (``sharding/tensor_parallel.py``) a rank runs its block of di/M
channels, the diagonal scan among them (``Mamba.split_dims``).

**RWKV6** (``Rwkv6Cfg``, the time mix, ``rwkv6_scan``, the channel mix,
``rwkv6_init_state``): token shift, the data-dependent lerp (ddlerp) of
five streams through tanh LoRAs, r/k/v/g projections, the decay
``log a = -exp(w)`` in f32, the chunked WKV, the ``ln_x`` RMSNorm over d
(the JAX package's stand-in for RWKV6's per-head GroupNorm, ported as JAX
has it) and the SiLU gate.  The WKV runs chunks of L = min(chunk, S),
identity-padded (log a = 0, k = 0).  In a chunk the strictly-causal scores
r̃_i·k̃_j = (r_i A_{i-1})·(k_j / A_j) hold ratios of decay products that
overflow floats when the decay is strong; with ``scan_impl="goom"`` they
are one ``engine.lmme`` call over GOOMs (on the card one launch of the
LMME kernel, even at decode, where the 1×1 product is masked away: JAX
makes the call too), and with ``"float"`` the conventional products.
Everything else in the scan is plain tensor work, as in JAX.

The token-shift caches (``x_prev``, the channel mix's ``cm_x_prev``) are
stored f32, the dtype JAX creates them in, and enter the shift cast to the
compute dtype; a step writes its last (compute-dtype) row back into them,
which f32 holds exactly.  JAX instead replaces the f32 buffer by the
compute-dtype row, so in JAX a cache's first bf16 step shifts in f32; one
dtype per buffer is what a replayed CUDA graph's static tensors need.

Under rules that split ``act_heads`` (``sharding/tensor_parallel.py``) the
time mix runs the rank's H/M heads (``Rwkv6TimeMix.split_dims``): r, k, v
and g column-split, ``out`` row-split and all-reduced, the WKV (its LMME
calls among it) and the ``wkv`` state at H/M heads.  The token shift, the
ddlerp and the decay LoRA's hidden run whole on every rank; each enters the
split where it meets a split weight, so their gradients are whole.
``ln_x`` normalises over all d channels: the f32 sum of squares of the
rank's block is all-reduced.  Under rules that split ``act_mlp`` the channel
mix runs the rank's block of d_ff (k column-split, v row-split and
all-reduced); its receptance ``r`` runs whole on every rank.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import MambaCfg, Rwkv6Cfg
from ..core import engine
from ..core.goom import Goom, from_goom, nonzero_sign, safe_abs, safe_log
from ..core.scan import associative_scan
from ..sharding.layout import TimeShards, time_shards
from ..sharding.rules import constrain
from ..sharding.tensor_parallel import Split, enter, leave, reduce, split_of
from .common import Dense, dense_apply, normal_param, wide, with_axes
from .norms import RMSNorm

__all__ = ["MambaCfg", "Mamba", "segment_states", "mamba_init_state", "Rwkv6Cfg",
           "Rwkv6TimeMix", "Rwkv6ChannelMix", "rwkv6_scan", "rwkv6_init_state"]


def segment_states(log_a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor],
                   impl: str = "goom", *, layout: Optional[TimeShards] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """All states of h_t = exp(log_a_t)·h_{t-1} + b_t within one chunk.

    log_a, b (L, ...); h0 (...).  ``impl="goom"``: the decays are log-native
    (sign +1), the inputs and the state enter through safe log and leave
    through ``from_goom``, and the scan is an engine call.  ``impl="float"``:
    the conventional baseline, the decays exp'd up front and an associative
    scan of (a, b) bracketed as ``jax.lax.associative_scan``.  Returns
    (states (L, ...), final state (...)).  With ``layout`` (goom only),
    log_a and b are this rank's time shard (L/P, B, ...), the scan starts
    from zero and the states returned are the shard's, with no final state."""
    if impl == "goom":
        a_g = Goom(log_a, torch.ones_like(log_a))
        b_g = Goom(safe_log(safe_abs(b)), nonzero_sign(b))
        if layout is not None:
            states_g = engine.diagonal_scan(layout.wrap(a_g, batch=1), layout.wrap(b_g, batch=1))
            return from_goom(layout.local(states_g)), None
        x0_g = Goom(safe_log(safe_abs(h0)), nonzero_sign(h0))
        states_g, carry_g = engine.diagonal_scan_carry(a_g, b_g, x0_g)
        return from_goom(states_g), from_goom(carry_g)

    def combine(e, l):
        return l[0] * e[0], l[0] * e[1] + l[1]

    # log_a <= 0: decay in (0, 1]; goomcheck: disable=GC202
    a_star, b_star = associative_scan(combine, (torch.exp(log_a), b))
    states = a_star * h0[None] + b_star
    return states, states[-1]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: max(x, 0) + log1p(exp(-|x|))."""
    # exp(-|x|) <= 1 and log1p of it is finite; goomcheck: disable=GC202
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


class Mamba(nn.Module):
    """One Mamba mixer; parameter names follow the JAX param tree."""

    def __init__(self, cfg: MambaCfg, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.scan_impl not in ("goom", "float"):
            raise ValueError(f"unknown scan_impl {cfg.scan_impl!r}; 'goom' or 'float'")
        self.cfg = cfg
        d, di, n, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.rank
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.in_proj = Dense(d, (2 * di,), **kw)
        self.conv_w = normal_param((cfg.d_conv, di), 0.02, axes=("conv", "mlp"), **kw)
        self.conv_b = with_axes(torch.zeros(di, device=device, dtype=dtype), ("mlp",))
        self.x_proj = Dense(di, (r + 2 * n,), in_axis="mlp", out_axes=(None,), **kw)
        self.dt_proj = Dense(r, (di,), in_axis=None, **kw)
        # Δ's bias: softplus⁻¹ of a log-uniform draw in [1e-3, 1e-1]
        u = torch.rand(di, generator=generator, device=device)
        # init-time, on a draw in [log 1e-3, log 1e-1]; goomcheck: disable=GC202
        dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        # init-time, dt0 in [1e-3, 1e-1]; goomcheck: disable=GC202
        self.dt_proj.b = with_axes(torch.log(torch.expm1(dt0)).to(dtype), ("mlp",))
        # S4D-real init: A[c, s] = -(s + 1)
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        # init-time, of a >= 1; goomcheck: disable=GC202
        self.a_log = with_axes(torch.log(a).expand(di, n).to(dtype).clone(), ("mlp", "state"))
        self.d_skip = with_axes(torch.ones(di, device=device, dtype=dtype), ("mlp",))
        self.out_proj = Dense(di, (d,), in_axis="mlp", out_axes=("embed",), **kw)

    def split_dims(self, rules) -> Tuple[Optional[str], Dict[str, Optional[int]]]:
        """The axis the channels split on (None: whole, also where the rules
        time-shard the scans on it) and the dim of each weight a rank reads
        a block of (``Attention.split_dims``).  ``in_proj``'s one (2·di)
        output holds [x; z], so a contiguous block of it is not a block of
        each: it is read whole and both halves' blocks taken."""
        axis = rules.split_axis("act_mlp", self.cfg.d_inner, scans=True)
        if axis is None:
            return None, {}
        return axis, {"in_proj.w": None, "conv_w": 1, "conv_b": 0, "x_proj.w": 0,
                      "dt_proj.w": 1, "dt_proj.b": 0, "a_log": 0, "d_skip": 0,
                      "out_proj.w": 0}

    def forward(self, x: torch.Tensor, *, state: Optional[Dict[str, torch.Tensor]] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
        """x (B, S, d) → (out (B, S, d), new state or None).  Under rules
        that split ``act_mlp`` a rank runs its block of the channels
        (:meth:`split_dims`): (Δ, B, C) are ``x_proj``'s partial sums,
        all-reduced, and ``out_proj``'s are all-reduced."""
        cfg, cd = self.cfg, compute_dtype
        b, s, _ = x.shape
        r, n, k = cfg.rank, cfg.d_state, cfg.d_conv
        di = cfg.d_inner
        sp = split_of("act_mlp", di, scans=True)

        x = enter(x, sp)
        w_in = self.in_proj.w if sp is None else in_proj_block(self.in_proj.w, sp, di)
        xi, z = dense_apply(w_in, x, compute_dtype=cd).chunk(2, dim=-1)   # (B,S,di)
        xi = constrain(xi, "batch", "act_seq", "act_mlp")

        # depthwise causal conv over time, kernel d_conv
        if state is not None:
            conv_in = torch.cat([state["conv"].to(cd), xi], dim=1)
            ci = conv_in
        else:
            conv_in = xi
            ci = F.pad(xi, (0, 0, k - 1, 0))
        conv_w, conv_b, a_log, d_skip = self.conv_w, self.conv_b, self.a_log, self.d_skip
        if sp is not None:
            conv_w = sp.take(conv_w, 1, di)
            conv_b, a_log, d_skip = (sp.take(t, 0, di) for t in (conv_b, a_log, d_skip))
        w = conv_w.to(cd)
        xconv = sum(ci[:, i:i + s] * w[i] for i in range(k)) + conv_b.to(cd)
        xc = F.silu(xconv)

        # input-dependent Δ, B, C
        dbc = reduce(self.x_proj(xc, compute_dtype=cd, split=(sp, 0, di)).float(), sp)
        dt_low, b_in, c_in = dbc.split([r, n, n], dim=-1)
        dt_w = self.dt_proj.w if sp is None else sp.take(self.dt_proj.w, 1, di)
        dt_b = self.dt_proj.b if sp is None else sp.take(self.dt_proj.b, 0, di)
        dt = _softplus(dt_low @ dt_w.float() + dt_b.float())
        # bounded S4D decay, negative; goomcheck: disable=GC202
        a = -torch.exp(a_log.float())                                # (di, n)
        h = (torch.zeros(b, xc.shape[-1], n, device=x.device) if state is None
             else state["ssm"])

        # under an engine mesh a loop of chunks would serialise the ranks:
        # the goom path hands the engine one full-length scan, which it
        # time-shards; the float baseline scans locally and keeps the chunk
        # loop (as JAX's ssm.py:375-389)
        goom = cfg.scan_impl == "goom"
        dtx = dt * xc.float()
        layout = time_shards() if goom and state is None else None
        if layout is not None:
            # each rank builds its time shard's (B, S/P, di, n) operands only
            # and gets its shard's states back; the outputs are gathered
            dt, dtx, b_in, c_in = (layout.shard(t, 1) for t in (dt, dtx, b_in, c_in))
            la = dt[..., None] * layout.replicated(a)              # (B,S/P,di,n)
            bb = dtx[..., None] * b_in[:, :, None, :]
            states, _ = segment_states(la.transpose(0, 1), bb.transpose(0, 1), None,
                                       layout=layout)
            y = layout.gather(torch.einsum("lbdn,bln->bld", states, c_in), 1, s)
        else:
            L = s if goom and engine.active_seq_shards() > 1 else min(cfg.chunk, s)
            pad = -s % L
            if pad:
                dt, dtx, b_in, c_in = (F.pad(t, (0, 0, 0, pad))
                                       for t in (dt, dtx, b_in, c_in))
            ys = []
            for c0 in range(0, s + pad, L):
                sl = slice(c0, c0 + L)
                if torch.is_grad_enabled():
                    # nested remat: the chunk's (B,L,di,n) operands and scan
                    # intermediates are rebuilt in the backward (JAX's
                    # @jax.checkpoint chunk_step)
                    h, yc = checkpoint(_chunk_step, dt[:, sl], dtx[:, sl], b_in[:, sl],
                                       c_in[:, sl], a, h, cfg.scan_impl,
                                       use_reentrant=False)
                else:
                    h, yc = _chunk_step(dt[:, sl], dtx[:, sl], b_in[:, sl], c_in[:, sl],
                                        a, h, cfg.scan_impl)
                ys.append(yc)
            y = torch.cat(ys, dim=1)[:, :s]

        y = y + xc.float() * d_skip.float()
        y = y.to(cd) * F.silu(z)
        out = leave(self.out_proj(y, compute_dtype=cd, split=(sp, 0, di)), sp)

        new_state = None
        if state is not None:
            new_state = {"conv": conv_in[:, -(k - 1):].float(), "ssm": h}
        return out, new_state


def in_proj_block(w: torch.Tensor, sp, di: int) -> torch.Tensor:
    """The rank's (d, 2·di/M) block of Mamba's (d, 2·di) ``in_proj``, whose
    output is [x; z]: its block of x's columns beside its block of z's, not
    a contiguous block of the weight (on two ranks that would hand one rank
    all of x and the other all of z)."""
    lo, k = sp.block(di)
    return torch.cat([w[:, lo:lo + k], w[:, di + lo:di + lo + k]], dim=1)


def _chunk_step(dt, dtx, b_in, c_in, a, h, impl: str):
    """One chunk of Mamba's scan: Δ (B,L,di), Δ·x (B,L,di), B and C (B,L,n),
    A (di, n), the entering state h (B,di,n) → (state after, y (B,L,di))."""
    la = dt[..., None] * a                             # (B,L,di,n), Δ·A: log-native
    bb = dtx[..., None] * b_in[:, :, None, :]          # (B,L,di,n)
    states, h = segment_states(la.transpose(0, 1), bb.transpose(0, 1), h, impl)
    return h, torch.einsum("lbdn,bln->bld", states, c_in)


def mamba_init_state(batch: int, cfg: MambaCfg, *, device) -> Dict[str, torch.Tensor]:
    """Zero conv tail (B, d_conv-1, d_inner) and SSM state (B, d_inner,
    d_state), both f32: the conv tail re-enters the conv at every chunk
    boundary, and a bf16 round trip there is where chunked prefill would
    part from the full-sequence scan.  Of the rank's channels under rules
    that split them."""
    sp = split_of("act_mlp", cfg.d_inner, scans=True)
    di = cfg.d_inner if sp is None else sp.block(cfg.d_inner)[1]
    return {
        "conv": torch.zeros(batch, cfg.d_conv - 1, di, device=device),
        "ssm": torch.zeros(batch, di, cfg.d_state, device=device),
    }


# ===========================================================================
# RWKV6 (Finch) — arXiv:2404.05892
# ===========================================================================
def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} along the sequence; the first step takes ``x_prev`` (the
    cache, cast to x's dtype) or zeros."""
    first = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev.to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


class _Lora(nn.Module):
    """tanh(x @ a) @ b; ``a`` (d, rank) drawn N(0, 0.01²), ``b`` (rank, out) zeros."""

    def __init__(self, d: int, rank: int, out: int, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out = out
        self.a = normal_param((d, rank), 0.01, axes=("embed", None), device=device,
                              dtype=dtype, generator=generator)
        self.b = with_axes(torch.zeros(rank, out, device=device, dtype=dtype), (None, "embed"))

    def forward(self, x: torch.Tensor, sp: Optional[Split] = None) -> torch.Tensor:
        """With ``sp``, the rank's block of the output: the whole hidden
        enters the split and meets ``b``'s block of columns."""
        hid = torch.tanh(x @ self.a.to(x.dtype))
        b = self.b if sp is None else sp.take(self.b, 1, self.out)
        return enter(hid, sp) @ b.to(x.dtype)


_MIX = ("w", "k", "v", "r", "g")


class Rwkv6TimeMix(nn.Module):
    """RWKV6's time mix; parameter names follow the JAX param tree
    (``mu_x``, ``mu.{w,k,v,r,g}``, ``lora.{w,k,v,r,g}.{a,b}``,
    ``decay_base``, ``decay_lora.{a,b}``, ``bonus`` (H, hd), ``r``/``k``/
    ``v``/``g``/``out`` ``.w`` (d, d) and ``ln_x.scale``)."""

    def __init__(self, cfg: Rwkv6Cfg, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.scan_impl not in ("goom", "float"):
            raise ValueError(f"unknown scan_impl {cfg.scan_impl!r}; 'goom' or 'float'")
        self.cfg = cfg
        d = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        gk = dict(kw, generator=generator)

        def half():
            return with_axes(torch.full((d,), 0.5, **kw), ("embed",))

        self.mu_x = half()
        self.mu = nn.ParameterDict({m: half() for m in _MIX})
        self.lora = nn.ModuleDict({m: _Lora(d, cfg.lora_mix, d, **gk) for m in _MIX})
        u = torch.rand(d, generator=generator, device=device)
        self.decay_base = with_axes((u - 5.0).to(dtype), ("embed",))
        self.decay_lora = _Lora(d, cfg.lora_decay, d, **gk)
        self.bonus = normal_param((cfg.n_heads, cfg.head_dim), 0.1, axes=("heads", "head_dim"),
                                  **gk)
        self.r, self.k, self.v, self.g = (Dense(d, (d,), in_axis="qkv_embed",
                                                out_axes=("heads",), **gk) for _ in range(4))
        self.out = Dense(d, (d,), in_axis="heads", out_axes=("embed",), **gk)
        self.ln_x = RMSNorm(d, **kw)

    def split_dims(self, rules) -> Tuple[Optional[str], Dict[str, Optional[int]]]:
        """The axis the heads split on (None: whole) and the dim of each
        weight a rank reads a block of (``Attention.split_dims``): r, k, v, g
        column-split, ``out`` row-split, and the per-channel ``bonus``,
        ``decay_base``, the decay LoRA's ``b`` and ``ln_x``'s scale read as
        the heads' block of channels."""
        axis = rules.split_axis("act_heads", self.cfg.n_heads)
        if axis is None:
            return None, {}
        return axis, {"r.w": 1, "k.w": 1, "v.w": 1, "g.w": 1, "out.w": 0, "bonus": 0,
                      "decay_base": 0, "decay_lora.b": 1, "ln_x.scale": 0}

    def forward(self, x: torch.Tensor, *, state: Optional[Dict[str, torch.Tensor]] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
        """x (B, S, d) → (out (B, S, d), new state or None); ``state`` holds
        ``x_prev`` (B, 1, d) and ``wkv`` (B, H, hd, hd) f32, of the rank's
        H/M heads under rules that split them (:meth:`split_dims`)."""
        cfg, cd = self.cfg, compute_dtype
        b, s, d = x.shape
        h, hd = cfg.n_heads, cfg.head_dim
        sp = split_of("act_heads", h)
        hl = h if sp is None else sp.block(h)[1]
        dx = _token_shift(x, None if state is None else state["x_prev"]) - x
        xxx = x + dx * self.mu_x.to(x.dtype)
        xw, xk, xv, xr, xg = (x + dx * (self.mu[m].to(x.dtype) + self.lora[m](xxx))
                              for m in _MIX)
        col = (sp, 1, d)
        r = self.r(enter(xr, sp), compute_dtype=cd, split=col).reshape(b, s, hl, hd)
        k = self.k(enter(xk, sp), compute_dtype=cd, split=col).reshape(b, s, hl, hd)
        v = self.v(enter(xv, sp), compute_dtype=cd, split=col).reshape(b, s, hl, hd)
        g = F.silu(self.g(enter(xg, sp), compute_dtype=cd, split=col))
        base, bonus = self.decay_base, self.bonus
        if sp is not None:
            base, bonus = sp.take(base, 0, d), sp.take(bonus, 0, h)
        # the log-decay, exact in log space: log a = -exp(w) < 0
        w = base.float() + self.decay_lora(xw.float(), sp)
        # bounded: -exp(w) < 0; goomcheck: disable=GC202
        log_a = -torch.exp(w).reshape(b, s, hl, hd)
        y, wkv = rwkv6_scan(r.float(), k.float(), v.float(), log_a, bonus.float(),
                            cfg, h0=None if state is None else state["wkv"])
        y = y.reshape(b, s, hl * hd)
        y = (self.ln_x(y) if sp is None else
             _split_rmsnorm(y, sp.take(self.ln_x.scale, 0, d), d, sp)).to(cd) * g
        out = leave(self.out(y, compute_dtype=cd, split=(sp, 0, d)), sp)
        if state is None:
            return out, None
        return out, {"x_prev": x[:, -1:].to(state["x_prev"].dtype), "wkv": wkv}


def _split_rmsnorm(y: torch.Tensor, scale: torch.Tensor, d: int, sp: Split,
                   eps: float = 1e-6) -> torch.Tensor:
    """``rmsnorm_apply`` over all ``d`` channels of a rank's block ``y``
    (..., d/M) of them: the f32 sum of squares all-reduced over the group,
    forward and backward (every rank's output depends on every block)."""
    yf = wide(y)
    var = reduce(yf.square().sum(dim=-1, keepdim=True), sp) / d
    return (yf * torch.rsqrt(var + eps) * scale.to(yf.dtype)).to(y.dtype)


def rwkv6_scan(r, k, v, log_a, u, cfg: Rwkv6Cfg, h0=None):
    """Chunked WKV: y_t = r_t · (S_{t-1} + diag(u)·k_t v_tᵀ);
    S_t = diag(a_t) S_{t-1} + k_t v_tᵀ.  All arguments f32.

    r, k, v, log_a (B, S, H, D); u (H, D); h0 (B, H, D, D) or None (zeros).
    Returns (y (B, S, H, D), final state (B, H, D, D)).  ``_rwkv6_scan`` of
    ``repro/models/ssm.py``, its ``lax.scan`` over chunks a Python loop."""
    b, s, h, dk = r.shape
    L = min(cfg.chunk, s)
    # identity-pad to whole chunks: log a = 0 and k = 0 leave the state be
    pad = -s % L
    if pad:
        r, k, v, log_a = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, log_a))
    sp = s + pad
    nc = sp // L
    dv = v.shape[-1]

    def chunks(t):  # (B, S, H, D) -> (nc, B, H, L, D)
        return t.reshape(b, nc, L, h, t.shape[-1]).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lac = chunks(r), chunks(k), chunks(v), chunks(log_a)
    S = torch.zeros(b, h, dk, dv, device=r.device) if h0 is None else h0
    # strictly causal (the current token is the bonus term's)
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=r.device), diagonal=-1)
    ub = u[None, :, None, :]
    ys = []
    for c in range(nc):
        rb, kb, vb, la = rc[c], kc[c], vc[c], lac[c]            # (B, H, L, D)
        cum = torch.cumsum(la, dim=-2)                          # log A_i
        cum_prev = cum - la                                     # log A_{i-1}
        total = cum[..., -1:, :]                                # log A_L
        if cfg.scan_impl == "goom":
            # scores over GOOMs: log r~ = log|r| + cum_prev, log k~ = log|k| - cum
            log_k, sign_k = safe_log(safe_abs(kb)), nonzero_sign(kb)
            rg = Goom(safe_log(safe_abs(rb)) + cum_prev, nonzero_sign(rb))
            kg = Goom((log_k - cum).mT, sign_k.mT)
            scores = from_goom(engine.lmme(rg, kg))            # (B, H, L, L)
            k_rem = from_goom(Goom(log_k + (total - cum), sign_k))
        else:
            # every exp of a cumulative decay <= 0 is at most 1 but exp(-cum):
            # the products overflow when the decay is strong (the "goom"
            # branch above); goomcheck: disable=GC202 on each line below
            scores = torch.einsum("bhik,bhjk->bhij", rb * torch.exp(cum_prev),
                                  kb * torch.exp(-cum))  # goomcheck: disable=GC202
            k_rem = kb * torch.exp(total - cum)  # goomcheck: disable=GC202
        scores = torch.where(mask, scores, 0.0)
        y = (torch.einsum("bhij,bhjv->bhiv", scores, vb)
             # decay <= 1; goomcheck: disable=GC202
             + torch.einsum("bhik,bhkv->bhiv", rb * torch.exp(cum_prev), S)
             + (rb * ub * kb).sum(dim=-1, keepdim=True) * vb)
        # decay <= 1; goomcheck: disable=GC202
        S = (torch.exp(total[..., 0, :])[..., :, None] * S
             + torch.einsum("bhjk,bhjv->bhkv", k_rem, vb))
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, sp, h, dk)[:, :s]
    return y, S


class Rwkv6ChannelMix(nn.Module):
    """RWKV6's channel mix: sigmoid(r(x_r)) · v(relu(k(x_k))²) over the
    token-shifted input; parameters ``mu_k``, ``mu_r``, ``k.w`` (d, d_ff),
    ``v.w`` (d_ff, d), ``r.w`` (d, d).  Under rules that split ``act_mlp`` a
    rank runs its block of d_ff: only x_k enters the split; the receptance
    runs whole on every rank (were x to enter, its gradient through r would
    be summed M times)."""

    def __init__(self, cfg: Rwkv6Cfg, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        self.mu_k = with_axes(torch.full((d,), 0.5, **kw), ("embed",))
        self.mu_r = with_axes(torch.full((d,), 0.5, **kw), ("embed",))
        self.k = Dense(d, (f,), generator=generator, **kw)
        self.v = Dense(f, (d,), generator=generator, in_axis="mlp", out_axes=("embed",), **kw)
        self.r = Dense(d, (d,), generator=generator, out_axes=(None,), **kw)
        self.d_ff = f

    def split_dims(self, rules) -> Tuple[Optional[str], Dict[str, Optional[int]]]:
        """The axis d_ff splits on (None: whole): k column-split, v row-split."""
        axis = rules.split_axis("act_mlp", self.d_ff)
        return (None, {}) if axis is None else (axis, {"k.w": 1, "v.w": 0})

    def forward(self, x: torch.Tensor, *, x_prev: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        cd, f = compute_dtype, self.d_ff
        sp = split_of("act_mlp", f)
        dx = _token_shift(x, x_prev) - x
        xk = x + dx * self.mu_k.to(x.dtype)
        xr = x + dx * self.mu_r.to(x.dtype)
        k = constrain(torch.relu(self.k(enter(xk, sp), compute_dtype=cd,
                                        split=(sp, 1, f))).square(),
                      "batch", "act_seq", "act_mlp")
        kv = leave(self.v(k, compute_dtype=cd, split=(sp, 0, f)), sp)
        return torch.sigmoid(self.r(xr, compute_dtype=cd)) * kv


def rwkv6_init_state(batch: int, cfg: Rwkv6Cfg, *, device) -> Dict[str, torch.Tensor]:
    """The time mix's decode state, f32 and zero: ``x_prev`` (B, 1, d) and
    ``wkv`` (B, H, hd, hd), of the rank's heads under rules that split them."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    sp = split_of("act_heads", h)
    h = h if sp is None else sp.block(h)[1]
    return {"x_prev": torch.zeros(batch, 1, d, device=device),
            "wkv": torch.zeros(batch, h, hd, hd, device=device)}
