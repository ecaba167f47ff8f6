"""Rotary position embeddings, the JAX package's half-split layout, full or
partial (``repro/models/rope.py``; M-RoPE is not ported yet)."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0, *, device=None) -> torch.Tensor:
    """Inverse frequencies for the rotating half (head_dim // 2 entries)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10000.0) -> torch.Tensor:
    """(..., S) int positions -> (..., S, head_dim // 2) angles."""
    inv = rope_frequencies(head_dim, theta, device=positions.device)
    return positions.float()[..., None] * inv


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
    ang = rope_angles(positions, rot_d, theta)           # (B, S, rot_d // 2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)       # (B, S, 1, rot_d // 2)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x_rot.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x_pass], dim=-1)
