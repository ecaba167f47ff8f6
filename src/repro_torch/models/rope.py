"""Position encodings (``repro/models/rope.py``): rotary embeddings in the
JAX package's half-split layout, full or partial; M-RoPE (Qwen2-VL,
arXiv:2409.12191), whose three position streams (temporal, height, width)
each rotate their own section of the frequencies; and the classic
sinusoidal embedding (MusicGen's positions)."""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch

from .common import wide_dtype


def rope_frequencies(head_dim: int, theta: float = 10000.0, *, device=None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse frequencies for the rotating half (head_dim // 2 entries), in
    ``dtype`` (f32; f64 for the float64 yardstick)."""
    exponent = torch.arange(0, head_dim, 2, dtype=dtype, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10000.0, *,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., S) int positions -> (..., S, head_dim // 2) angles in ``dtype``."""
    inv = rope_frequencies(head_dim, theta, device=positions.device, dtype=dtype)
    return positions.to(dtype)[..., None] * inv


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate x (B, S, H, 2n) by angles (B, S, n): the table is built in f32
    (f64 for f64 ``x``) and cast to ``x.dtype`` before the product, as in
    JAX."""
    cos = torch.cos(ang)[..., None, :].to(x.dtype)       # (B, S, 1, n)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0, rotary_fraction: float = 1.0) -> torch.Tensor:
    """Rotate ``x`` (B, S, H, D) at ``positions`` (B, S): the first and
    second halves of the rotated dims are each pair's two coordinates.

    ``rotary_fraction`` < 1 rotates only the first ``int(D * f)`` dims,
    rounded down to even (GLM's partial rotary); the rest pass through.
    No rotated dim at all (``f = 0``) is the identity."""
    rot_d = int(x.shape[-1] * rotary_fraction)
    rot_d -= rot_d % 2
    if rot_d == 0:
        return x
    x_rot, x_pass = x[..., :rot_d], x[..., rot_d:]
    ang = rope_angles(positions, rot_d, theta, dtype=wide_dtype(x.dtype))
    return torch.cat([_rotate(x_rot, ang), x_pass], dim=-1)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, *,
                theta: float = 1_000_000.0,
                sections: Sequence[int] = (16, 24, 24)) -> torch.Tensor:
    """M-RoPE: x (B, S, H, D) at positions3 (3, B, S) = (temporal, height,
    width).  ``sections`` are in half-dim units (sum D // 2; Qwen2-VL's
    (16, 24, 24) at head dim 128): frequency slot j rotates by the stream
    whose section holds j.  Equal streams give 1-D RoPE."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to {half}")
    wd = wide_dtype(x.dtype)
    inv = rope_frequencies(x.shape[-1], theta, device=x.device, dtype=wd)   # (half,)
    ang = positions3.to(wd)[..., None] * inv                          # (3, B, S, half)
    # the stream of each slot, from arithmetic on the device alone (no host
    # copy, so that a CUDA graph can capture it)
    slot = torch.arange(half, device=x.device)
    stream = torch.zeros_like(slot)                                    # (half,)
    for edge in list(itertools.accumulate(sections))[:-1]:
        stream += slot >= edge
    ang = torch.gather(ang.movedim(0, -1), -1,
                       stream.expand(ang.shape[1:]).unsqueeze(-1))[..., 0]  # (B, S, half)
    return _rotate(x, ang)


def sinusoidal_embedding(positions: torch.Tensor, dim: int, *,
                         max_period: float = 10000.0) -> torch.Tensor:
    """(..., S) positions -> (..., S, dim) f32 ``[cos, sin]`` embeddings over
    ``dim // 2`` frequencies, zero-padded by one column at odd ``dim``."""
    half = dim // 2
    # -log(max_period) * i / half <= 0: frequencies in (0, 1]; goomcheck: disable=GC202
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
