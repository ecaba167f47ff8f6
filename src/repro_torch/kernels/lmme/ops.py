"""Wrapper of the CUDA LMME kernel (``csrc/lmme.cu``).

``lmme_cuda(a, b)`` takes ``(..., n, d)`` and ``(..., d, m)`` GOOMs whose
leading dims broadcast like ``torch.matmul``.  On CUDA f32 planes it launches
the kernel on the current stream, passing broadcast batch dims as strides
(nothing is expanded or padded in memory), and raises on anything the kernel
does not take.  On CPU planes it computes the plain version, because there
is no kernel there to launch.

Backward, as in the JAX wrapper (``repro/kernels/lmme/ops.py``), is autograd
of the plain ``lmme_reference`` on the saved inputs; sign planes get no
gradient.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.goom import Goom
from .ref import lmme_ref

__all__ = ["lmme_cuda"]

_MAX_BATCH_DIMS = 6  # kMaxBatchDims in csrc/lmme.cu
_I64 = ctypes.c_int64
_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        from ..build import load

        fn = load("lmme").repro_lmme_forward
        ptr, i32, p64 = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_I64)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                       i32, p64, p64, p64,
                       i32, i32, i32, _I64, _I64, _I64, _I64, ptr]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _paired(log: torch.Tensor, sign: torch.Tensor):
    """Both planes of one operand with one set of strides (the kernel reads
    them at the same offsets).  Copies only the un-broadcast operand."""
    if log.shape != sign.shape:
        raise ValueError(f"log plane {tuple(log.shape)} and sign plane "
                         f"{tuple(sign.shape)} differ in shape")
    if log.stride() != sign.stride():
        log, sign = log.contiguous(), sign.contiguous()
    return log, sign


def _launch(al, asn, bl, bsn):
    planes = (al, asn, bl, bsn)
    dev = al.device
    for x in planes:
        if x.device != dev:
            raise ValueError(f"LMME operands on {x.device} and {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"the CUDA LMME kernel takes float32 planes, "
                            f"got {x.dtype}")
        if x.ndim < 2:
            raise ValueError("LMME operands need at least 2 dims")
    al, asn = _paired(al, asn)
    bl, bsn = _paired(bl, bsn)
    n, d = al.shape[-2:]
    d2, m = bl.shape[-2:]
    if d != d2:
        raise ValueError(f"contraction mismatch: {tuple(al.shape)} @ "
                         f"{tuple(bl.shape)}")
    batch = torch.broadcast_shapes(al.shape[:-2], bl.shape[:-2])
    if len(batch) > _MAX_BATCH_DIMS:
        raise ValueError(f"at most {_MAX_BATCH_DIMS} batch dims, got {len(batch)}")
    out_log = torch.empty(batch + (n, m), dtype=torch.float32, device=dev)
    out_sign = torch.empty_like(out_log)
    if out_log.numel() == 0:
        return out_log, out_sign
    ae = al.expand(batch + (n, d))
    be = bl.expand(batch + (d, m))
    nb = len(batch)
    sizes = (_I64 * max(nb, 1))(*batch)
    a_strides = (_I64 * max(nb, 1))(*ae.stride()[:nb])
    b_strides = (_I64 * max(nb, 1))(*be.stride()[:nb])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel_fn()(
        al.data_ptr(), asn.data_ptr(), bl.data_ptr(), bsn.data_ptr(),
        out_log.data_ptr(), out_sign.data_ptr(),
        nb, sizes, a_strides, b_strides, n, d, m,
        ae.stride(-2), ae.stride(-1), be.stride(-2), be.stride(-1), stream)
    if rc != 0:
        raise RuntimeError(f"LMME kernel launch failed: cudaError_t {rc}")
    lmme_cuda.launches += 1
    return out_log, out_sign


class _LmmeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, al, asn, bl, bsn):
        out_log, out_sign = _launch(al, asn, bl, bsn)
        ctx.save_for_backward(al, asn, bl, bsn)
        ctx.mark_non_differentiable(out_sign)
        return out_log, out_sign

    @staticmethod
    def backward(ctx, g_log, _g_sign):
        al, asn, bl, bsn = ctx.saved_tensors
        need_a, _, need_b, _ = ctx.needs_input_grad
        with torch.enable_grad():
            al_ = al.detach().requires_grad_(need_a)
            bl_ = bl.detach().requires_grad_(need_b)
            out, _ = lmme_ref(al_, asn, bl_, bsn)
            wrt = [t for t, need in ((al_, need_a), (bl_, need_b)) if need]
            grads = iter(torch.autograd.grad(out, wrt, g_log))
        d_al = next(grads) if need_a else None
        d_bl = next(grads) if need_b else None
        return d_al, None, d_bl, None


def lmme_cuda(a: Goom, b: Goom) -> Goom:
    """LMME over GOOMs through the CUDA kernel (plain version on the CPU)."""
    planes = (a.log_abs, a.sign, b.log_abs, b.sign)
    if all(x.device.type == "cpu" for x in planes):
        return Goom(*lmme_ref(*planes))
    return Goom(*_LmmeFn.apply(*planes))


#: kernel launches since the last reset (set to 0 to reset)
lmme_cuda.launches = 0
