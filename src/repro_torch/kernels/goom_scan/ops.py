"""Wrappers of the CUDA scan kernels: the matrix scan (``csrc/matrix_scan.cu``
with B, ``csrc/matrix_scan_zero_b.cu`` without) and the diagonal scan
(``csrc/diag_scan.cu``).

**Matrix scan.**

``matrix_scan_cuda(a, b, x0)`` takes the engine's convention: a (T, ..., d, d)
transitions, b (T, ..., d, m) biases, x0 (..., d, m) entering state or None
(exact zeros); batch dims broadcast.  ``b=None`` is the zero-B form
X_t = (A_t ··· A_1) X_0, which needs ``x0`` (it fixes m).  Returns all
states, (T, ..., d, m).  With B it is one kernel a call: at d <= 32 a warp
walks each chunk of ``with_b_chunk_len(T, d)`` steps (part, stitch and
fix-up inside the one block; one chunk is the plain walk), above d = 32 a
block walks time in order.  The zero-B form is three passes (part,
stitch, fix-up; with a scale kernel between the first two and, above
d = 16, an exp pre-pass) over chunks of ``zero_b_chunk_len(T, d)`` steps,
with scratch the wrapper allocates: the chunks' products and entering
states with f64 logs, and A's exps.

On CUDA f32 planes it launches the kernel on the current stream.  Operands
go in by strides: time and the collapsed batch dims each as one stride, so a
time-invariant A is a stride-0 view that is never materialised.  An operand
is copied only when its batch dims cannot be collapsed into one stride
(``matrix_scan_cuda.copies`` counts those copies).  T, d and m are taken as
they are: nothing is padded.  d above 128, non-f32 planes and mixed devices
raise.  On CPU planes it computes the plain version, because there is no
kernel there to launch.  On FakeTensor operands (either op, any device) it
copies, allocates the outputs and scratch as on the card (``copies`` moves,
``launches`` does not) and launches nothing (``kernels/shape_only.py``).

**Diagonal scan.**  ``diagonal_scan_cuda(a, b, x0)``: a and b (T, ...)
broadcast to one shape, x0 (...) or None (exact zeros).  Returns all
states, (T, ...).  The trailing dims go in flattened into one channel axis C
as one stride per plane (a stride of 0 broadcasts); an operand whose dims
do not collapse into one stride is copied (``diagonal_scan_cuda.copies``).
T and C are taken as they are: nothing is padded.  Non-f32 planes and mixed
devices raise; CPU planes compute the plain version.

Backward of both, as in the JAX wrapper (``repro/kernels/goom_scan/ops.py``),
is autograd of the plain version on the saved inputs; sign planes get no
gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ...core.goom import Goom
from .. import shape_only
from .ref import goom_diag_scan_ref, matrix_scan_ref, matrix_scan_zero_b_ref

__all__ = ["MAX_D", "diagonal_scan_cuda", "matrix_scan_cuda", "with_b_chunk_len",
           "zero_b_chunk_len"]

MAX_D = 128  # kMaxD in csrc/matrix_scan.cu and csrc/matrix_scan_zero_b.cu
_I64 = ctypes.c_int64
_FNS = {}


def _kernel_fn(has_b: bool):
    fn = _FNS.get(has_b)
    if fn is None:
        from ..build import load

        ptr, i32, p64 = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_I64)
        if has_b:
            fn = load("matrix_scan").repro_matrix_scan_forward
            fn.argtypes = [ptr] * 8 + [i32] * 5 + [p64] * 3 + [ptr]
        else:
            fn = load("matrix_scan_zero_b").repro_matrix_scan_zero_b_forward
            fn.argtypes = [ptr] * 13 + [i32] * 5 + [p64] * 2 + [ptr]
        fn.restype = ctypes.c_int
        _FNS[has_b] = fn
    return fn


_SMS = 132  # streaming multiprocessors of an H100 SXM


def zero_b_chunk_len(t: int, d: int) -> int:
    """L, the time chunk of the zero-B kernel's three passes: the least power
    of two with 2 L^2 >= T and with the part pass's blocks, one per chunk
    and column tile of d (ceil(d / 32) tiles above d = 16), fitting one wave
    of one block per SM.  The part pass walks L - 1 dependent steps, the
    stitch ceil(T / L) - 1 and the fix-up L: 2 L + T / L is least at
    L = sqrt(T / 2), unless the chunks' blocks would queue behind each other
    (d = 128 at T = 2001: 64, not 32).  A function of (T, d) alone, never of
    G, m or the call."""
    tiles = 1 if d <= 16 else -(-d // 32)
    ell = 1
    while 2 * ell * ell < t or ell * _SMS < t * tiles:
        ell *= 2
    return ell


# with B, T up to this walks in one chunk: on the card the one-chunk walk
# is faster at T = 17 and as fast at T = 24 with a time-invariant A
WALK_MAX_T = 24


def with_b_chunk_len(t: int, d: int) -> int:
    """L, the time chunk of the with-B kernel at d <= 32: T itself (one
    chunk, the plain walk) at T <= WALK_MAX_T and above d = 32; else the
    least power of two with L^2 >= T whose K = ceil(T / L) chunks, one warp
    each, fit the block (16 chunks at d <= 16, 4 at d <= 32, where A_t's
    copies and the chunks' products take four times the shared memory).
    The part walks L - 1 steps, the stitch K - 1 and the fix-up L: about
    2 sqrt(T) instead of T.  A function of (T, d) alone, never of G, m or
    the call."""
    if d > 32 or t <= WALK_MAX_T:
        return max(t, 1)
    kmax = 16 if d <= 16 else 4
    ell = 1
    while ell * ell < t or ell * kmax < t:
        ell *= 2
    return ell


def zero_b_kernels(t: int, d: int) -> int:
    """Kernels one zero-B call launches: part, scale, stitch and fix-up, or
    only stitch and fix-up when T fits one chunk; and above d = 16 the exp
    pre-pass first."""
    return (4 if t > zero_b_chunk_len(t, d) else 2) + (d > 16)


def _collapsed_stride(shape, strides) -> Optional[int]:
    """The one stride that walks ``shape``'s dims in row-major order, or None
    when no single stride does (size-1 dims are free)."""
    dims = [(n, s) for n, s in zip(shape, strides) if n != 1]
    for (_, s0), (n1, s1) in zip(dims, dims[1:]):
        if s0 != s1 * n1:
            return None
    return dims[-1][1] if dims else 0


def _strides(log: torch.Tensor, sign: torch.Tensor, shape, timed: bool):
    """Both planes of one operand expanded to ``shape`` ((T,) + batch + (r, c)
    when ``timed``, else batch + (r, c)) with one set of strides, and those
    strides as (t, g, r, c) or (g, r, c).  Copies only what cannot be
    passed as strides."""
    log, sign = log.expand(shape), sign.expand(shape)
    lead = 1 if timed else 0
    g = _collapsed_stride(shape[lead:-2], log.stride()[lead:-2])
    if log.stride() != sign.stride() or g is None:
        log, sign = log.contiguous(), sign.contiguous()
        matrix_scan_cuda.copies += 1
        g = _collapsed_stride(shape[lead:-2], log.stride()[lead:-2])
    st = log.stride()
    vals = ((st[0],) if timed else ()) + (g, st[-2], st[-1])
    return log, sign, (_I64 * len(vals))(*vals)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _launch(al, asn, bl, bsn, xl, xs, ell=None):
    """The kernel on CUDA planes; ``ell`` overrides the time chunk L of
    either form (``with_b_chunk_len`` / ``zero_b_chunk_len`` when None;
    ``ell=T`` is the one-chunk walk).  ``matrix_scan_cuda.last_chunk``
    records (has_b, T, d, L) of the launch."""
    has_b = bl is not None
    planes = [p for p in (al, asn, bl, bsn, xl, xs) if p is not None]
    dev = al.device
    for x in planes:
        if x.device != dev:
            raise ValueError(f"matrix-scan operands on {x.device} and {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"the CUDA matrix-scan kernel takes float32 planes, "
                            f"got {x.dtype}")
    if al.ndim < 3 or al.shape[-1] != al.shape[-2]:
        raise ValueError(f"a must be (T, ..., d, d), got {tuple(al.shape)}")
    t, d = al.shape[0], al.shape[-1]
    if d > MAX_D:
        raise ValueError(f"the CUDA matrix-scan kernel takes d <= {MAX_D}, got {d}")
    m = (bl if has_b else xl).shape[-1]
    batch = al.shape[1:-2]
    if has_b:
        if bl.ndim < 3 or bl.shape[0] != t or bl.shape[-2] != d:
            raise ValueError(f"b must be (T={t}, ..., {d}, m), got {tuple(bl.shape)}")
        batch = torch.broadcast_shapes(batch, bl.shape[1:-2])
    if xl is not None:
        if tuple(xl.shape[-2:]) != (d, m):
            raise ValueError(f"x0 must be (..., {d}, {m}), got {tuple(xl.shape)}")
        if torch.broadcast_shapes(batch, xl.shape[:-2]) != batch:
            raise ValueError(f"x0 batch {tuple(xl.shape[:-2])} does not broadcast "
                             f"to {tuple(batch)}")
    out_log = torch.empty((t,) + batch + (d, m), dtype=torch.float32, device=dev)
    out_sign = torch.empty_like(out_log)
    g = math.prod(batch)
    if out_log.numel() == 0:
        return out_log, out_sign
    al, asn, a_st = _strides(al, asn, (t,) + batch + (d, d), True)
    x_st = (_I64 * 3)(0, 0, 0)
    if xl is not None:
        xl, xs, x_st = _strides(xl, xs, batch + (d, m), False)
    ell = ell or (with_b_chunk_len(t, d) if has_b else zero_b_chunk_len(t, d))
    if has_b:
        bl, bsn, b_st = _strides(bl, bsn, (t,) + batch + (d, m), True)
        if shape_only.is_fake(al):   # the dry-run's cost pass: shapes, no launch
            shape_only.record("matrix_scan", t=t, g=g, d=d, m=m, a_fixed=a_st[0] == 0)
            return out_log, out_sign
        rc = _kernel_fn(True)(
            _ptr(al), _ptr(asn), _ptr(bl), _ptr(bsn), _ptr(xl), _ptr(xs),
            out_log.data_ptr(), out_sign.data_ptr(), t, g, d, m,
            ell, a_st, b_st, x_st, torch.cuda.current_stream(dev).cuda_stream)
    else:
        # scratch of the three passes: each chunk's product but the last's,
        # and the state entering each chunk, both with f64 logs
        k = -(-t // ell)
        p_log = torch.empty((k - 1, g, d, d), dtype=torch.float64, device=dev)
        p_sign = torch.empty((k - 1, g, d, d), dtype=torch.float32, device=dev)
        p_rmax = torch.empty((k - 1, g, d), dtype=torch.float64, device=dev)
        in_log = torch.empty((k, g, d, m), dtype=torch.float64, device=dev)
        in_sign = torch.empty((k, g, d, m), dtype=torch.float32, device=dev)
        # above d = 16, A's exps (rows padded to a multiple of 4) and row
        # maxima, taken once per step (once for a time-invariant A)
        ta = 0 if d <= 16 else 1 if a_st[0] == 0 else t
        a_exp = torch.empty((ta, g, d, -(-d // 4) * 4), dtype=torch.float32, device=dev)
        a_rmax = torch.empty((ta, g, d), dtype=torch.float32, device=dev)
        if shape_only.is_fake(al):   # the scratch allocated, no launch
            shape_only.record("matrix_scan_zero_b", t=t, g=g, d=d, m=m, a_fixed=a_st[0] == 0)
            return out_log, out_sign
        rc = _kernel_fn(False)(
            _ptr(al), _ptr(asn), _ptr(xl), _ptr(xs),
            out_log.data_ptr(), out_sign.data_ptr(), p_log.data_ptr(),
            p_sign.data_ptr(), p_rmax.data_ptr(), in_log.data_ptr(), in_sign.data_ptr(),
            a_exp.data_ptr(), a_rmax.data_ptr(), t, g, d, m, ell, a_st, x_st,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"matrix-scan kernel launch failed: cudaError_t {rc}")
    if has_b:
        matrix_scan_cuda.launches += 1
    else:
        matrix_scan_cuda.launches_zero_b += 1
        matrix_scan_cuda.kernels_zero_b += (4 if k > 1 else 2) + (d > 16)
    matrix_scan_cuda.last_chunk = (has_b, t, d, ell)
    return out_log, out_sign


def _plain(al, asn, bl, bsn, xl, xs) -> Goom:
    a = Goom(al, asn)
    x0 = None if xl is None else Goom(xl, xs)
    if bl is None:
        return matrix_scan_zero_b_ref(a, x0)
    return matrix_scan_ref(a, Goom(bl, bsn), x0)


class _MatrixScanFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, al, asn, bl, bsn, xl, xs, ell):
        out_log, out_sign = _launch(al, asn, bl, bsn, xl, xs, ell)
        ctx.save_for_backward(al, asn, bl, bsn, xl, xs)
        ctx.mark_non_differentiable(out_sign)
        return out_log, out_sign

    @staticmethod
    def backward(ctx, g_log, _g_sign):
        al, asn, bl, bsn, xl, xs = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            logs = [None if x is None else x.detach().requires_grad_(need[i])
                    for i, x in ((0, al), (2, bl), (4, xl))]
            out = _plain(logs[0], asn, logs[1], bsn, logs[2], xs).log_abs
            wrt = [x for x in logs if x is not None and x.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g_log))
        d_al, d_bl, d_xl = (next(grads) if x is not None and x.requires_grad else None
                            for x in logs)
        return d_al, None, d_bl, None, d_xl, None, None


def matrix_scan_cuda(a: Goom, b: Optional[Goom], x0: Optional[Goom] = None,
                     ell: Optional[int] = None) -> Goom:
    """All states of X_t = A_t X_{t-1} ⊕ B_t (B = 0 when ``b`` is None)
    through the CUDA kernel, in time chunks of ``ell`` (None: the form's
    default); the plain version on CPU planes."""
    if b is None and x0 is None:
        raise ValueError("matrix_scan_cuda(a, None) needs x0: with B = 0 and "
                         "X_0 = 0 every state is zero, and x0 fixes the width m")
    planes = (a.log_abs, a.sign,
              None if b is None else b.log_abs, None if b is None else b.sign,
              None if x0 is None else x0.log_abs, None if x0 is None else x0.sign)
    if all(x.device.type == "cpu" for x in planes if x is not None) \
            and not shape_only.is_fake(a.log_abs):
        return _plain(*planes)
    return Goom(*_MatrixScanFn.apply(*planes, ell))


#: calls that launched since the last reset (set to 0 to reset): with B,
#: and zero-B; a zero-B call launches ``zero_b_kernels(T, d)`` kernels,
#: counted in ``kernels_zero_b``
matrix_scan_cuda.launches = 0
matrix_scan_cuda.launches_zero_b = 0
matrix_scan_cuda.kernels_zero_b = 0
#: operands copied because their batch dims did not collapse into one stride
matrix_scan_cuda.copies = 0
#: (has_b, T, d, L) of the last launch: the time chunk it ran with
matrix_scan_cuda.last_chunk = None


# ---------------------------------------------------------------------------
# diagonal scan:  x_t = a_t ⊙ x_{t-1} ⊕ b_t
# ---------------------------------------------------------------------------
_DIAG_FN = None


def _diag_kernel_fn():
    global _DIAG_FN
    if _DIAG_FN is None:
        from ..build import load

        fn = load("diag_scan").repro_diag_scan_forward
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ptr, _I64, _I64] * 2 + [ptr, ptr, _I64, ptr, ptr,
                                                    _I64, _I64, ptr]
        fn.restype = ctypes.c_int
        _DIAG_FN = fn
    return _DIAG_FN


def _channel_strides(log: torch.Tensor, sign: torch.Tensor, shape, timed: bool):
    """Both planes of one operand expanded to ``shape`` ((T,) + trail when
    ``timed``, else trail) with one set of strides, and those strides as
    (t, c) or (c,), the trailing dims walked as one channel axis.  Copies
    only what cannot be passed as strides."""
    log, sign = log.expand(shape), sign.expand(shape)
    lead = 1 if timed else 0
    c = _collapsed_stride(shape[lead:], log.stride()[lead:])
    if log.stride() != sign.stride() or c is None:
        log, sign = log.contiguous(), sign.contiguous()
        diagonal_scan_cuda.copies += 1
        c = _collapsed_stride(shape[lead:], log.stride()[lead:])
    return log, sign, ((log.stride(0),) if timed else ()) + (c,)


def _diag_launch(al, asn, bl, bsn, xl, xs):
    planes = [p for p in (al, asn, bl, bsn, xl, xs) if p is not None]
    dev = al.device
    for x in planes:
        if x.device != dev:
            raise ValueError(f"diagonal-scan operands on {x.device} and {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"the CUDA diagonal-scan kernel takes float32 "
                            f"planes, got {x.dtype}")
    if al.ndim < 1 or bl.ndim < 1:
        raise ValueError("a and b need a leading time axis")
    shape = torch.broadcast_shapes(al.shape, bl.shape)
    t, trail = shape[0], tuple(shape[1:])
    if xl is not None and torch.broadcast_shapes(trail, xl.shape) != trail:
        raise ValueError(f"x0 {tuple(xl.shape)} does not broadcast to {trail}")
    out_log = torch.empty(shape, dtype=torch.float32, device=dev)
    out_sign = torch.empty_like(out_log)
    c = math.prod(trail)
    if out_log.numel() == 0:
        return out_log, out_sign
    al, asn, (a_t, a_c) = _channel_strides(al, asn, shape, True)
    bl, bsn, (b_t, b_c) = _channel_strides(bl, bsn, shape, True)
    x_c = 0
    if xl is not None:
        xl, xs, (x_c,) = _channel_strides(xl, xs, trail, False)
    if shape_only.is_fake(al):   # the dry-run's cost pass: shapes, no launch
        shape_only.record("diag_scan", t=t, c=c)
        return out_log, out_sign
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _diag_kernel_fn()(
        al.data_ptr(), asn.data_ptr(), a_t, a_c, bl.data_ptr(), bsn.data_ptr(),
        b_t, b_c, _ptr(xl), _ptr(xs), x_c, out_log.data_ptr(),
        out_sign.data_ptr(), t, c, stream)
    if rc != 0:
        raise RuntimeError(f"diagonal-scan kernel launch failed: cudaError_t {rc}")
    diagonal_scan_cuda.launches += 1
    return out_log, out_sign


def _diag_plain(al, asn, bl, bsn, xl, xs) -> Goom:
    x0 = None if xl is None else Goom(xl, xs)
    return goom_diag_scan_ref(Goom(al, asn), Goom(bl, bsn), x0)


class _DiagScanFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, al, asn, bl, bsn, xl, xs):
        out_log, out_sign = _diag_launch(al, asn, bl, bsn, xl, xs)
        ctx.save_for_backward(al, asn, bl, bsn, xl, xs)
        ctx.mark_non_differentiable(out_sign)
        return out_log, out_sign

    @staticmethod
    def backward(ctx, g_log, _g_sign):
        al, asn, bl, bsn, xl, xs = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            logs = [None if x is None else x.detach().requires_grad_(need[i])
                    for i, x in ((0, al), (2, bl), (4, xl))]
            out = _diag_plain(logs[0], asn, logs[1], bsn, logs[2], xs).log_abs
            wrt = [x for x in logs if x is not None and x.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g_log))
        d_al, d_bl, d_xl = (next(grads) if x is not None and x.requires_grad else None
                            for x in logs)
        return d_al, None, d_bl, None, d_xl, None


def diagonal_scan_cuda(a: Goom, b: Goom, x0: Optional[Goom] = None) -> Goom:
    """All states of x_t = a_t ⊙ x_{t-1} ⊕ b_t through the CUDA kernel; the
    plain version on CPU planes."""
    planes = (a.log_abs, a.sign, b.log_abs, b.sign,
              None if x0 is None else x0.log_abs, None if x0 is None else x0.sign)
    if all(x.device.type == "cpu" for x in planes if x is not None) \
            and not shape_only.is_fake(a.log_abs):
        return _diag_plain(*planes)
    return Goom(*_DiagScanFn.apply(*planes))


#: launches since the last reset (set to 0 to reset)
diagonal_scan_cuda.launches = 0
#: operands copied because their trailing dims did not collapse into one stride
diagonal_scan_cuda.copies = 0
