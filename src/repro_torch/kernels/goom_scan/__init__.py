"""The fused matrix scan over GOOMs: the CUDA kernel (with and without B),
its wrapper and its plain version."""

from .ops import MAX_D, matrix_scan_cuda
from .ref import REF_CHUNK, matrix_scan_ref, matrix_scan_zero_b_ref

__all__ = ["MAX_D", "REF_CHUNK", "matrix_scan_cuda", "matrix_scan_ref",
           "matrix_scan_zero_b_ref"]
