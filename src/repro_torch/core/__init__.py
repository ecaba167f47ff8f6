"""GOOM substrate: the split representation, real ops over it, the engine."""

from . import engine
from .goom import (
    LOG_ZERO,
    Goom,
    finite_floor,
    from_goom,
    goom_from_complex,
    goom_ones,
    goom_to_complex,
    goom_zeros,
    nonzero_sign,
    safe_abs,
    safe_log,
    signed_exp,
    to_goom,
)
from .ops import (
    goom_add,
    goom_dot,
    goom_lse,
    goom_matmul,
    goom_mul,
    goom_neg,
    goom_norm,
    goom_normalize_cols,
    goom_scale,
    goom_sub,
    lmme_naive,
    lmme_reference,
    scaled_exp,
)

__all__ = [
    "engine", "LOG_ZERO", "Goom", "finite_floor", "from_goom", "goom_from_complex",
    "goom_ones", "goom_to_complex", "goom_zeros", "nonzero_sign", "safe_abs",
    "safe_log", "signed_exp", "to_goom", "goom_add", "goom_dot", "goom_lse",
    "goom_matmul", "goom_mul", "goom_neg", "goom_norm", "goom_normalize_cols",
    "goom_scale", "goom_sub", "lmme_naive", "lmme_reference", "scaled_exp",
]
