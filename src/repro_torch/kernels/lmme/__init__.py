"""LMME over GOOMs: the CUDA kernel, its wrapper and its plain version."""

from .ops import lmme_cuda
from .ref import lmme_ref, lmme_ref_exact

__all__ = ["lmme_cuda", "lmme_ref", "lmme_ref_exact"]
