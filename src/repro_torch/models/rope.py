"""Rotary position embeddings, the JAX package's half-split layout
(``repro/models/rope.py``; partial rotation and M-RoPE are not ported)."""

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
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x`` (B, S, H, D), D even, at ``positions`` (B, S): the first
    and second halves of D are each pair's two coordinates."""
    ang = rope_angles(positions, x.shape[-1], theta)      # (B, S, D // 2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)       # (B, S, 1, D // 2)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
