"""The paper's deep RNN layer (§4.3): a non-diagonal SSM over GOOMs.

Per head:  x_t = A·x_{t-1} + B·u_t ; y_t = C·x_t + D·u_t  (eq. 25), with the
recurrence over GOOMs, LSE(LMME(A', x'_{t-1}), LMME(B', u'_t)) (eq. 26), and
no stabilization of any kind.  States come back to floats through the scaled
exponentiation of eq. 27.

Layer: LayerNorm → linear (heads) → GOOM scan → scaled exp → C, D → GLU →
linear.  Counterpart of ``repro/models/goom_layer.py``.  ``cfg.scan_variant``
picks the scan:

  * ``shared_a`` exploits the time-invariant A with doubling on the vector
    side; every GOOM product is an ``engine.lmme`` call, on the card a
    launch of the CUDA LMME kernel;
  * ``generic`` is the paper-literal eq. 26: one ``engine.matrix_scan_carry``
    call per layer, on the card one launch of the fused matrix-scan kernel.
    Under an engine mesh (``engine.active_seq_shards() > 1``) ``shared_a``
    takes this path too, so that the scan is time-sharded.  Under rules
    that map ``scan_seq`` to a ``DeviceMesh`` axis (``sharding.layout``),
    a rank builds B·u, scans and applies C, D and the GLU on its time shard
    alone, and the GLU's output is gathered along time before ``out_proj``.

B·u is an ``engine.lmme`` call in both.

The model axis (``sharding/tensor_parallel.py``): under rules that split
``act_heads``, a rank runs its block of H/M heads (``in_proj``, A, B, C and
D column-split, ``out_proj`` row-split and all-reduced), so every GOOM op of
the layer (the LMMEs of ``shared_a``, the with-B matrix scan of
``generic``) runs on H/M heads; the max of eq. 27's scaled exponentiation,
over every head, is all-reduced.  Under rules that also time-shard the
scans on that axis (the launcher's ``--seq-shards``) the layer keeps whole
heads and time-shards as above: a departure from JAX, which reshards the
heads to time there, with equal values.

The GOOM operands and states are f32 whatever the compute dtype, f64 for
f64 parameters (the one-process float64 yardstick).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import GoomSSMCfg
from ..core import engine
from ..core.goom import Goom, finite_floor, to_goom
from ..core.ops import goom_add, scaled_exp
from ..sharding.layout import TimeShards, time_shards
from ..sharding.rules import constrain
from ..sharding.tensor_parallel import all_max, enter, leave, split_of
from .common import Dense, chunk_len, wide, wide_dtype, with_axes
from .norms import LayerNorm

_FLOOR = finite_floor(torch.float32)


def _cat(gs: List[Goom]) -> Goom:
    return Goom(torch.cat([g.log_abs for g in gs]),
                torch.cat([g.sign for g in gs]))


def _scan_shared_a(
    a_g: Goom,            # (H, d, d) time-invariant transition
    bu_g: Goom,           # (S, B, H, d, 1) inputs B·u_t
    x0: Optional[Goom],   # (B, H, d, 1) entering state, or None
    chunk: int,
) -> Tuple[Goom, Goom]:
    """All prefix states, exploiting the time-invariant A.

    Within a chunk of length L (``chunk_len``), Hillis-Steele doubling runs
    on the vector side alone:

        b_i ← LSE( LMME(A^(2^k), b_{i-2^k}), b_i );   A^(2^(k+1)) = (A^(2^k))²

    and the entering state is folded into each chunk's first element.  The
    shifted operand is padded with the finite floor (an exact zero that
    keeps gradients finite), as in the JAX package.
    Returns (states (S,B,H,d,1), final state (B,H,d,1)).
    """
    s = bu_g.shape[0]
    L = chunk_len(s, chunk)
    nc = s // L

    def chunk_prefix(b: Goom) -> Goom:
        a_pow = a_g
        k = 1
        while k < L:
            pad_shape = (k,) + tuple(b.shape[1:])
            shifted = Goom(
                torch.cat([torch.full(pad_shape, _FLOOR, dtype=b.dtype,
                                      device=b.device), b.log_abs[:-k]]),
                torch.cat([torch.ones(pad_shape, dtype=b.sign.dtype,
                                      device=b.device), b.sign[:-k]]),
            )
            b = goom_add(engine.lmme(a_pow, shifted), b)
            if 2 * k < L:
                a_pow = engine.lmme(a_pow, a_pow)
            k *= 2
        return b

    if x0 is None:
        bsz, h, hd = bu_g.shape[1], bu_g.shape[2], a_g.shape[-1]
        shape = (bsz, h, hd, 1)
        x0 = Goom(torch.full(shape, _FLOOR, device=bu_g.device, dtype=bu_g.dtype),
                  torch.ones(shape, device=bu_g.device, dtype=bu_g.dtype))

    carry = x0
    states = []
    for c in range(nc):
        b_chunk = bu_g[c * L:(c + 1) * L]
        # fold the carry into the first element: b_1 ← LSE(A·x0, b_1)
        first = goom_add(engine.lmme(a_g, carry), b_chunk[0])
        b_chunk = _cat([first[None], b_chunk[1:]])
        st = chunk_prefix(b_chunk)
        carry = st[-1]
        states.append(st)
    return _cat(states), carry


def _scan_generic(
    a_g: Goom,            # (H, d, d) time-invariant transition
    bu_g: Goom,           # (S, B, H, d, 1) inputs B·u_t
    x0: Optional[Goom],   # (B, H, d, 1) entering state, or None
    layout: Optional[TimeShards] = None,
) -> Tuple[Goom, Optional[Goom]]:
    """All states through the engine's matrix scan (paper eq. 26).

    The batch rides in the state columns, (S,B,H,d,1) → (S,H,d,B): the
    recurrence is column-independent and A is shared across the batch.  A
    goes in as a stride-0 view over S, never materialised.  Returns
    (states (S,B,H,d,1), final state (B,H,d,1)).  With ``layout``, ``bu_g``
    is this rank's time shard and so are the states; no final state.
    """
    s, _, h = bu_g.shape[:3]
    d = a_g.shape[-1]

    def cols(g: Goom) -> Goom:   # (S,B,H,d,1) -> (S,H,d,B)
        return Goom(g.log_abs[..., 0].permute(0, 2, 3, 1),
                    g.sign[..., 0].permute(0, 2, 3, 1))

    a_s = Goom(a_g.log_abs.expand(s, h, d, d), a_g.sign.expand(s, h, d, d))
    carry = None
    if layout is not None:
        states_c = layout.local(engine.matrix_scan(layout.wrap(a_s), layout.wrap(cols(bu_g),
                                                                               batch=3)))
    else:
        x0c = None
        if x0 is not None:   # (B,H,d,1) -> (H,d,B)
            x0c = Goom(x0.log_abs[..., 0].permute(1, 2, 0),
                       x0.sign[..., 0].permute(1, 2, 0))
        states_c, carry_c = engine.matrix_scan_carry(a_s, cols(bu_g), x0c)
        carry = Goom(carry_c.log_abs.permute(2, 0, 1)[..., None],
                     carry_c.sign.permute(2, 0, 1)[..., None])
    states = Goom(states_c.log_abs.permute(0, 3, 1, 2)[..., None],
                  states_c.sign.permute(0, 3, 1, 2)[..., None])
    return states, carry


class GoomSSM(nn.Module):
    """One goom_ssm mixer; parameter names follow the JAX param tree."""

    def __init__(self, cfg: GoomSSMCfg, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.scan_variant not in ("shared_a", "generic"):
            raise ValueError(f"unknown scan_variant {cfg.scan_variant!r}")
        self.cfg = cfg
        d, hd, h = cfg.d_model, cfg.head_dim, cfg.n_heads
        kw = dict(device=device, dtype=dtype)

        ax = ("heads", "head_dim", "head_dim")

        def normal(std, shape):
            return with_axes(std * torch.randn(shape, generator=generator, **kw), ax)

        self.ln = LayerNorm(d, **kw)
        self.in_proj = Dense(d, (h, hd), generator=generator, out_axes=("heads", "head_dim"),
                             **kw)
        # A near-identity with small noise: a stable start, free to grow or
        # shrink in training (the point of the paper)
        eye = torch.eye(hd, **kw)[None] * 0.9
        self.A = with_axes(
            eye + 0.1 * torch.randn((h, hd, hd), generator=generator, **kw)
            / hd ** 0.5, ax)
        self.B = normal(0.5 / hd ** 0.5, (h, hd, hd))
        self.C = normal(0.5 / hd ** 0.5, (h, hd, 2 * hd))
        self.D = normal(0.5 / hd ** 0.5, (h, hd, 2 * hd))
        self.out_proj = Dense(h * hd, (d,), generator=generator, in_axis="heads",
                              out_axes=("embed",), **kw)

    def split_dims(self, rules) -> Tuple[Optional[str], Dict[str, Optional[int]]]:
        """The axis the heads split on (None: whole, also where the rules
        time-shard the scans on it) and the dim of each weight a rank reads
        a block of (``Attention.split_dims``); ``ln`` runs before the split."""
        axis = rules.split_axis("act_heads", self.cfg.n_heads, scans=True)
        if axis is None:
            return None, {}
        return axis, {"in_proj.w": 1, "A": 0, "B": 0, "C": 0, "D": 0, "out_proj.w": 0}

    def forward(self, x: torch.Tensor, *,
                state: Optional[Dict[str, torch.Tensor]] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
        """x (B, S, d) → (out (B, S, d), new state or None)."""
        b, s, _ = x.shape
        h, hd = self.cfg.n_heads, self.cfg.head_dim
        sp = split_of("act_heads", h, scans=True)
        wd = wide_dtype(self.A.dtype)

        xin = enter(self.ln(x), sp)
        u = self.in_proj(xin, compute_dtype=wd, split=(sp, 1, h))   # (B,S,H,hd)
        u = constrain(u, "batch", "act_seq", "act_heads", None)

        # under rules that time-shard the scans, each rank builds its time
        # shard's operands and states only; the GLU's output is gathered
        layout = time_shards() if state is None else None
        A, B, C, D = self.A, self.B, self.C, self.D
        if sp is not None:
            A, B, C, D = (sp.take(w, 0, h) for w in (A, B, C, D))
        if layout is not None:
            u = layout.shard(u, 1)
            A, B, C, D = (layout.replicated(w) for w in (A, B, C, D))
        a_g = to_goom(wide(A), use_floor=True)
        b_g = to_goom(wide(B), use_floor=True)
        u_g = to_goom(u, use_floor=True)

        # B·u_t over GOOMs: (H,hd,hd) ∘ (S,B,H,hd,1), A broadcast by strides
        u_col = Goom(u_g.log_abs.permute(1, 0, 2, 3)[..., None],
                     u_g.sign.permute(1, 0, 2, 3)[..., None])
        bu = engine.lmme(b_g, u_col)

        x0 = None if state is None else Goom(state["x_log"], state["x_sign"])
        # the shared-A doubling is a host loop of LMMEs, local by nature:
        # under a mesh the layer hands the engine one full-length matrix scan,
        # which the engine time-shards (as JAX's goom_layer.py:232-236)
        if self.cfg.scan_variant == "shared_a" and engine.active_seq_shards() == 1:
            states, final = _scan_shared_a(a_g, bu, x0, self.cfg.chunk)
        else:
            states, final = _scan_generic(a_g, bu, x0, layout)

        # back to floats (eq. 27): one max over heads and head_dim per
        # position (over every rank's heads when they are split)
        xs = Goom(states.log_abs[..., 0].permute(1, 0, 2, 3),   # (B,S,H,hd)
                  states.sign[..., 0].permute(1, 0, 2, 3))
        over = {} if sp is None else {"reduce_max": lambda m: all_max(m, sp)}
        vals, _ = scaled_exp(xs, dim=(-2, -1), shift=2.0, **over)

        cd = compute_dtype
        y = torch.einsum("bshd,hde->bshe", vals.to(cd), C.to(cd))
        y = y + torch.einsum("bshd,hde->bshe", u.to(cd), D.to(cd))
        y1, y2 = y.chunk(2, dim=-1)
        y = (y1 * torch.sigmoid(y2)).flatten(2)              # GLU (B,S,H·hd)
        if layout is not None:
            y = layout.gather(y, 1, s)
        out = leave(self.out_proj(y, compute_dtype=cd, split=(sp, 0, h * hd)), sp)

        new_state = None
        if state is not None:
            new_state = {"x_log": final.log_abs, "x_sign": final.sign}
        return out, new_state


def goom_ssm_init_state(batch: int, cfg: GoomSSMCfg, *, device) -> Dict[str, torch.Tensor]:
    """The fixed-size decode state: an all-zero (floored) (B,H,hd,1) carry,
    of the rank's heads under rules that split them."""
    sp = split_of("act_heads", cfg.n_heads, scans=True)
    heads = cfg.n_heads if sp is None else sp.block(cfg.n_heads)[1]
    shape = (batch, heads, cfg.head_dim, 1)
    return {
        "x_log": torch.full(shape, _FLOOR, dtype=torch.float32, device=device),
        "x_sign": torch.ones(shape, dtype=torch.float32, device=device),
    }
