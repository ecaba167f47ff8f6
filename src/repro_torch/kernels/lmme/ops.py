"""Wrapper of the CUDA LMME kernel (``csrc/lmme.cu``).

``lmme_cuda(a, b)`` takes ``(..., n, d)`` and ``(..., d, m)`` GOOMs whose
leading dims broadcast like ``torch.matmul``.  On CUDA f32 planes it launches
the kernel on the current stream, passing broadcast batch dims as strides
(nothing is expanded or padded in memory), and raises on anything the kernel
does not take.  The kernel has two launch shapes, picked from the call's
shape by ``batched_plan``: batched small products whose A is broadcast over
rows of B (the serving path), and output tiles for the rest; an output gets
the same bits from either.  On CPU planes it computes the plain version,
because there is no kernel there to launch.  On FakeTensor operands, on any
device, it allocates the outputs and launches nothing
(``kernels/shape_only.py``).

Backward, as in the JAX wrapper (``repro/kernels/lmme/ops.py``), is autograd
of the plain ``lmme_reference`` on the saved inputs; sign planes get no
gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...core.goom import Goom
from .. import shape_only
from .ref import lmme_ref

__all__ = ["batched_plan", "lmme_cuda"]

_MAX_BATCH_DIMS = 6  # kMaxBatchDims in csrc/lmme.cu
# the batched launch shape's limits (csrc/lmme.cu): d and n at most 64, one
# output per thread of a 256-thread block, a block's B columns staged in
# 64 * 65 floats, at most 65535 blocks along Q
_BATCHED_MAX_D = _BATCHED_MAX_N = 64
_THREADS = 256
_BATCHED_STAGE = 64 * 65
_I64 = ctypes.c_int64
_FNS = {}


def _kernel_fn(batched: bool):
    fn = _FNS.get(batched)
    if fn is None:
        from ..build import load

        lib = load("lmme")
        ptr, i32, p64 = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_I64)
        if batched:
            fn = lib.repro_lmme_batched_forward
            fn.argtypes = [ptr] * 6 + [p64, p64] + [i32] * 4 + [_I64] * 4 + [ptr]
        else:
            fn = lib.repro_lmme_forward
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                           i32, p64, p64, p64,
                           i32, i32, i32, _I64, _I64, _I64, _I64, ptr]
        fn.restype = ctypes.c_int
        _FNS[batched] = fn
    return fn


def _collapse(dims):
    """(size, a, b, out strides) of row-major ``dims`` walked as one dim, or
    None when one stride cannot walk them all."""
    if not dims:
        return (1, 0, 0, 0)
    for (_, *outer), (size, *inner) in zip(dims, dims[1:]):
        if any(o != i * size for o, i in zip(outer, inner)):
            return None
    return (math.prod(d[0] for d in dims),) + tuple(dims[-1][1:])


def batched_plan(batch, a_strides, b_strides, n: int, d: int, m: int):
    """The batched launch shape's (V, Q, qb) for a call, or None for the
    tiled one: the batch dims A varies over collapse into V, those A is
    broadcast over (stride 0) into Q, each into one stride of A, B and the
    output; qb rows of Q per block.  Picked from the shape alone; both shapes
    give each output the same bits."""
    if d > _BATCHED_MAX_D or n > _BATCHED_MAX_N or n * m > _THREADS \
            or m * (d + 1) > _BATCHED_STAGE:
        return None
    out_strides = [n * m] * len(batch)
    for k in range(len(batch) - 2, -1, -1):
        out_strides[k] = out_strides[k + 1] * batch[k + 1]
    dims = [x for x in zip(batch, a_strides, b_strides, out_strides) if x[0] != 1]
    v = _collapse([x for x in dims if x[1] != 0])
    q = _collapse([x for x in dims if x[1] == 0])
    if v is None or q is None:
        return None
    qb = max(1, min(q[0], _THREADS // (n * m), _BATCHED_STAGE // (m * (d + 1))))
    if -(-q[0] // qb) > 65535:
        return None
    return v, q, qb


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
    if shape_only.is_fake(al):   # the dry-run's cost pass: shapes, no launch
        shape_only.record("lmme", a_shape=tuple(al.shape), b_shape=tuple(bl.shape))
        return out_log, out_sign
    planes = (al.data_ptr(), asn.data_ptr(), bl.data_ptr(), bsn.data_ptr(),
              out_log.data_ptr(), out_sign.data_ptr())
    mat = (ae.stride(-2), ae.stride(-1), be.stride(-2), be.stride(-1))
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = batched_plan(batch, ae.stride()[:nb], be.stride()[:nb], n, d, m) if d else None
    if plan is not None:
        v, q, qb = plan
        rc = _kernel_fn(True)(*planes, (_I64 * 4)(*v), (_I64 * 4)(*q), qb,
                              n, d, m, *mat, stream)
    else:
        sizes = (_I64 * max(nb, 1))(*batch)
        a_strides = (_I64 * max(nb, 1))(*ae.stride()[:nb])
        b_strides = (_I64 * max(nb, 1))(*be.stride()[:nb])
        rc = _kernel_fn(False)(*planes, nb, sizes, a_strides, b_strides,
                               n, d, m, *mat, stream)
    if rc != 0:
        raise RuntimeError(f"LMME kernel launch failed: cudaError_t {rc}")
    lmme_cuda.launches += 1
    lmme_cuda.launches_batched += plan is not None
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
    if all(x.device.type == "cpu" for x in planes) and not shape_only.is_fake(a.log_abs):
        return Goom(*lmme_ref(*planes))
    return Goom(*_LmmeFn.apply(*planes))


#: kernel launches since the last reset (set to 0 to reset), and how many of
#: them took the batched launch shape
lmme_cuda.launches = 0
lmme_cuda.launches_batched = 0
