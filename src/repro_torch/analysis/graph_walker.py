"""Graph layer: an abstract interpreter over the aten ops the port dispatches.

The port's counterpart of ``repro/analysis/jaxpr_walker.py``.  Where JAX
walks a jaxpr, the port runs the target itself on fake tensors
(``FakeTensorMode``: shapes and dtypes, no data, no device work) under a
``TorchDispatchMode`` stacked above the fake mode.  Each aten op reaches
:class:`Walk` while the Python frames that made it are still live, so a
finding carries the ``file:line`` of the innermost frame of the port (or of
the analysed fixture), and the walk can see which sanctioned wrapper, if
any, the op runs inside.  Every tensor carries an
:class:`~repro_torch.analysis.lattice.AbsVal`; the GC1xx rules:

  GC101  aten.exp of a log magnitude with no dominating max-subtraction
  GC102  narrowing float cast of a log-space value (``_to_copy``,
         ``prims.convert_element_type``, a ``copy_`` into a narrower tensor)
  GC103  aten.log outside ``safe_log``
  GC104  sum / mean / cumsum / mm / bmm / addmm / baddbmm over linear values
         exp'd from unrescaled logs
  GC105  a host read: ``aten._local_scalar_dense`` (``.item()``,
         ``int()``/``float()``/``bool()`` of a tensor), an op whose output
         shape depends on the data (``nonzero``, ``masked_select``,
         ``unique``), a copy from a CUDA tensor to the CPU

Boundaries
----------
The three autograd functions of ``core/goom.py`` are the sanctioned
wrappers (JAX's ``custom_jvp`` boundary): ops inside their forwards are not
checked, and their outputs are a fresh log magnitude (``_SafeLog``), linear
(``_SignedExp``) or the join of the operands (``_SafeAbs``).  The autograd
functions of the CUDA kernels' wrappers (``kernels/lmme/ops.py``,
``kernels/goom_scan/ops.py``) are JAX's ``pallas_call``: on fake tensors a
wrapper takes its shape-only branch (``kernels/shape_only.py``), which is
one opaque step; every op inside takes the join of the kernel's operands,
and nothing inside is checked.

A ``.item()`` on a fake tensor raises in the fake mode; the walk reports it
as GC105 and hands back a zero of the right type, so the trace goes on and
the host read is never mistaken for a clean run.
"""

from __future__ import annotations

import functools
import sys
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import shape_only
from .lattice import LINEAR, UNKNOWN, AbsVal, TokenSource, join
from .registry import RULES
from .report import Finding

__all__ = ["Walk", "trace_and_walk"]

_aten = torch.ops.aten

# reductions that collapse an axis in linear space
_PRODUCTS = frozenset({_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm,
                       _aten.mv, _aten.dot, _aten.addmv, _aten.addbmm})
_SUMS = frozenset({_aten.sum, _aten.nansum, _aten.mean, _aten.cumsum,
                   _aten.cumprod})
# running maxima: their output is a max over its operand's origins
_MAX_OPS = frozenset({_aten.amax.default, _aten.max.default, _aten.max.dim,
                      _aten.cummax.default})
# fresh values: no operand's domain flows into them
_FACTORIES = frozenset({
    _aten.zeros, _aten.ones, _aten.full, _aten.empty, _aten.empty_strided,
    _aten.zeros_like, _aten.ones_like, _aten.full_like, _aten.empty_like,
    _aten.rand_like, _aten.randn_like, _aten.new_zeros, _aten.new_ones,
    _aten.new_full, _aten.new_empty, _aten.new_empty_strided, _aten.arange,
    _aten.eye, _aten.scalar_tensor, _aten.lift_fresh, _aten.lift_fresh_copy,
    _aten.rand, _aten.randn, _aten.randint, _aten.linspace, _aten.fill_,
    _aten.zero_,
})
# ops whose output shape depends on the data: a host read
_DATA_SHAPED = frozenset({_aten.nonzero, _aten.masked_select, _aten._unique,
                          _aten._unique2, _aten.unique_dim,
                          _aten.unique_consecutive})
_CASTS = frozenset({_aten._to_copy.default,
                    torch.ops.prims.convert_element_type.default})


@functools.lru_cache(maxsize=None)
def _boundaries() -> Dict[object, str]:
    """Code object of each sanctioned forward -> what its ops produce."""
    from ..core import goom
    from ..kernels.goom_scan import ops as scan_ops
    from ..kernels.lmme import ops as lmme_ops

    return {
        goom._SafeLog.forward.__code__: "log",
        goom._SignedExp.forward.__code__: "linear",
        goom._SafeAbs.forward.__code__: "join",
        lmme_ops._LmmeFn.forward.__code__: "kernel",
        scan_ops._MatrixScanFn.forward.__code__: "kernel",
        scan_ops._DiagScanFn.forward.__code__: "kernel",
    }


def _narrower(new: torch.dtype, old: torch.dtype) -> bool:
    return (new.is_floating_point and old.is_floating_point
            and torch.finfo(new).bits < torch.finfo(old).bits)


def _zero_of(t: torch.Tensor):
    if t.dtype == torch.bool:
        return False
    return 0.0 if t.dtype.is_floating_point else 0


class Walk(TorchDispatchMode):
    """The domain walk of one target.  ``locate(filename)`` gives the
    relative path of a file whose frames findings may point at, or None.
    Enter it inside a ``FakeTensorMode``; :meth:`seed` the arguments'
    domains, then call the target."""

    def __init__(self, target: str, locate: Callable[[str], Optional[str]],
                 tokens: Optional[TokenSource] = None):
        super().__init__()
        self.target = target
        self.locate = locate
        self.tokens = tokens or TokenSource()
        self.findings: List[Finding] = []
        self.vals = WeakIdKeyDictionary()
        self.ops = 0            # aten ops walked
        self.log_values = 0     # ops whose output is a log magnitude
        self.kernel_steps = 0   # shape-only kernel calls
        self._stop = None       # the frame the walk was entered from

    # -- values ---------------------------------------------------------------
    def seed(self, pairs) -> None:
        for t, v in pairs:
            self.vals[t] = v

    def value(self, t: torch.Tensor) -> AbsVal:
        v = self.vals.get(t)
        if v is None:   # a parameter or a tensor made before the walk
            return LINEAR if t.dtype.is_floating_point else UNKNOWN
        return v

    def _operands(self, args, kwargs) -> List[AbsVal]:
        """The float tensor operands' values (what domain joins range over)."""
        return [self.value(t) for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor) and t.dtype.is_floating_point]

    def _assign(self, out, val: AbsVal) -> None:
        n = 0
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.vals[t] = val
                n += 1
        if n and val.domain == "log":
            self.log_values += 1

    # -- where an op comes from ---------------------------------------------
    def _context(self):
        """(boundary kind, boundary frame, (file, line)) of the running op:
        the innermost sanctioned forward on the stack, and the innermost
        frame of a located file."""
        bounds = _boundaries()
        kind = bframe = where = None
        f = sys._getframe(2)
        while f is not None and f is not self._stop:
            code = f.f_code
            if kind is None:
                kind = bounds.get(code)
                if kind is not None:
                    bframe = f
            if where is None:
                rel = self.locate(code.co_filename)
                if rel is not None:
                    where = (rel, f.f_lineno)
            if kind is not None and where is not None:
                break
            f = f.f_back
        return kind, bframe, where

    def _emit(self, rule: str, where, message: str) -> None:
        file, line = where if where is not None else ("<unknown>", 0)
        self.findings.append(Finding(
            rule=rule, severity=RULES[rule].severity, file=file, line=line,
            message=message, target=self.target))

    def _kernel_operands(self, frame) -> AbsVal:
        """The join of a kernel forward's tensor arguments."""
        code = frame.f_code
        local = frame.f_locals
        return join(self.value(local[n]) for n in code.co_varnames[:code.co_argcount]
                    if isinstance(local.get(n), torch.Tensor)
                    and local[n].dtype.is_floating_point)

    # -- the interpreter ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        kind, bframe, where = self._context()
        if kind is not None:
            out = func(*args, **kwargs)
            if kind == "kernel":
                val = self._kernel_operands(bframe)
            elif kind == "log":
                val = AbsVal(domain="log", origin=frozenset({self.tokens.fresh()}))
            elif kind == "linear":
                val = LINEAR
            else:
                val = join(self._operands(args, kwargs))
            self._assign(out, val)
            return out
        val, out = self._rule(func, args, kwargs, where)
        self._assign(out, val)
        return out

    def _rule(self, func, args, kwargs, where) -> Tuple[AbsVal, object]:
        packet = func._overloadpacket
        vals = self._operands(args, kwargs)
        j = join(vals)

        if func is _aten._local_scalar_dense.default:
            self._emit("GC105", where,
                       "host read of a tensor's value (.item(), int(), float() "
                       "or bool() of a tensor) in the traced hot path")
            return UNKNOWN, _zero_of(args[0])

        if packet in _DATA_SHAPED:
            self._emit("GC105", where,
                       f"`{packet.__name__}` has an output shape that depends "
                       "on the data: a host read in the traced hot path")
            from torch._subclasses.fake_tensor import DynamicOutputShapeException

            try:
                return j, func(*args, **kwargs)
            except DynamicOutputShapeException:
                x = args[0]
                if packet is _aten.nonzero:     # its largest shape
                    return UNKNOWN, torch.empty((x.numel(), x.dim()),
                                                dtype=torch.long, device=x.device)
                if packet is _aten.masked_select:
                    n = torch.broadcast_shapes(x.shape, args[1].shape).numel()
                    return j, torch.empty((n,), dtype=x.dtype, device=x.device)
                raise

        out = func(*args, **kwargs)

        if packet in _FACTORIES:
            return UNKNOWN, out

        if packet is _aten.log or packet is _aten.log_:
            self._emit("GC103", where,
                       "bare `aten.log`: not inside safe_log (paper eq. 6: "
                       "the derivative must be floored)")
            return AbsVal(domain="log", origin=frozenset({self.tokens.fresh()})), out

        if packet is _aten.exp or packet is _aten.exp_:
            escape = j.domain == "log" and not j.rescaled
            if escape:
                self._emit("GC101", where,
                           "exp of a log-space magnitude with no dominating "
                           "max-subtraction: overflow escape from GOOM space")
            return AbsVal(domain="linear", from_log=escape, origin=j.origin), out

        if func in _CASTS:
            x = args[0]
            new = kwargs.get("dtype") if func is _aten._to_copy.default else args[1]
            if j.domain == "log" and new is not None and _narrower(new, x.dtype):
                self._emit("GC102", where,
                           f"log-space value demoted {x.dtype}->{new}: log "
                           "carries need full f32 precision")
            dev = kwargs.get("device")
            if dev is not None and x.device.type == "cuda" \
                    and torch.device(dev).type == "cpu":
                self._emit("GC105", where,
                           "copy of a CUDA tensor to the CPU in the traced "
                           "hot path")
            return j, out

        if func is _aten.copy_.default:
            dst, src = args[0], args[1]
            sv = self.value(src)
            if sv.domain == "log" and _narrower(dst.dtype, src.dtype):
                self._emit("GC102", where,
                           f"log-space value copied {src.dtype}->{dst.dtype}: "
                           "log carries need full f32 precision")
            if src.device.type == "cuda" and dst.device.type == "cpu":
                self._emit("GC105", where,
                           "copy of a CUDA tensor to the CPU in the traced "
                           "hot path")
            return sv, out

        if func in _MAX_OPS:
            return AbsVal(domain=j.domain, rescaled=j.rescaled, origin=j.origin,
                          max_of=j.origin | j.max_of), out

        if func in (_aten.sub.Tensor, _aten.sub_.Tensor) \
                and isinstance(args[1], torch.Tensor):
            a, b = self.value(args[0]), self.value(args[1])
            rescaled = bool(b.max_of & a.origin) or j.rescaled
            return AbsVal(domain=j.domain, rescaled=rescaled, from_log=j.from_log,
                          origin=j.origin), out

        if packet in _PRODUCTS or packet in _SUMS:
            if any(v.from_log for v in vals):
                self._emit("GC104", where,
                           f"`{packet.__name__}` over linear values exp'd from "
                           "an unrescaled log magnitude: bypasses the "
                           "max-rescaled LSE/LMME monoid")
            if packet in _PRODUCTS:
                return AbsVal(domain="linear",
                              from_log=any(v.from_log for v in vals)), out
            return j, out

        return j, out   # views, copies, elementwise ops, where: the join

    # -- running a target -----------------------------------------------------
    def _on_kernel(self, kernel, dims) -> None:
        self.kernel_steps += 1

    def run(self, fn, args):
        """Call ``fn(*args)`` under the walk (inside the caller's fake mode)."""
        self._stop = sys._getframe()
        with shape_only.listening(self._on_kernel), self:
            return fn(*args)


def trace_and_walk(fn, args, seeds, *, target: str,
                   locate: Callable[[str], Optional[str]],
                   tokens: Optional[TokenSource] = None) -> Walk:
    """Walk ``fn(*args)`` with ``seeds`` (``(tensor, AbsVal)`` pairs); the
    arguments are fake tensors of the fake mode the caller is in.  Returns
    the :class:`Walk` (its findings and counts), also when the call raised:
    the exception is set as ``walk.error``."""
    w = Walk(target, locate, tokens)
    w.seed(seeds)
    w.error = None
    try:
        w.run(fn, args)
    except Exception as e:   # the caller records a skip
        w.error = e
    return w
