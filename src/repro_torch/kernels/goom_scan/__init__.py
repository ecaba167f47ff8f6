"""The GOOM scans: the CUDA kernels of the fused matrix scan (with and
without B) and of the diagonal scan, their wrappers and plain versions."""

from .ops import MAX_D, diagonal_scan_cuda, matrix_scan_cuda
from .ref import REF_CHUNK, goom_diag_scan_ref, matrix_scan_ref, matrix_scan_zero_b_ref

__all__ = ["MAX_D", "REF_CHUNK", "diagonal_scan_cuda", "goom_diag_scan_ref",
           "matrix_scan_cuda", "matrix_scan_ref", "matrix_scan_zero_b_ref"]
