"""One cost pass of a step on fake tensors: FLOPs, bytes, memory, launches.

The port's counterpart of ``repro/launch/hlo_cost.py``: where JAX walks a
compiled HLO module, the port runs its real step under ``FakeTensorMode``
(no device, nothing allocated or launched) and watches every dispatched op:

  * **FLOPs** of the products and attention by ``FlopCounterMode``'s
    formulas (``torch.utils.flop_counter.flop_registry``), split by the
    operands' dtype: f32 products run off the tensor cores (TF32 off),
    the rest on them.  The GOOM kernels, which that table cannot see, add
    their own operations (``roofline.lmme_work``, ``scan_work``,
    ``diag_work``; all f32).
  * **Bytes**: each op's input and output bytes, views left out, and
    ``empty`` allocations, which move nothing (``bytes``: eager PyTorch
    writes every op's output to memory, the counterpart of JAX's
    fusion-boundary ``hlo_bytes_upper``); and each op's output bytes alone
    (``written``: every result is written once, while its reads may come
    from the card's 50 MB L2), which the roofline's memory term reads.  A
    GOOM kernel counts its work's bytes in both.
  * **Memory**: ``torch.distributed._tools.mem_tracker.MemTracker`` over
    the same pass; the peak by category (parameters, gradients, the
    ``state`` handed in, activations, temporaries).  The step's gradients
    come from ``torch.autograd.grad``, not ``.grad``, so the tracker counts
    them under temporaries.
  * **Launches**: each GOOM kernel's shape-only calls in the pass
    (``kernels/shape_only.py``), counted here: the wrappers' own
    ``launches`` counters do not move.
  * **The model axis's collectives**: the bytes of each all-reduce and
    all-gather a split module runs (``sharding/tensor_parallel.py``'s
    listener), summed by kind and group size (``collectives``); they move
    nothing over the fake process group, and the dry-run adds them to the
    parameters' collectives (``launch/dryrun.py``).

:func:`periods` makes a model's cost from one period of each group: a
trace at one period a group, and one more for each group with two; the
difference is one period, times ``n_periods - 1``.  The periods are
identical, so this is exact for FLOPs, bytes and launches (JAX's
trip-count analysis does the same for scanned layers).  Memory combines
the same way region by region (``REGIONS``: before the blocks, their
forward, the loss, their backward, the update): within one, persistent
state plus each period's saved activations (or, in the backward, the
larger of those and each period's gradients) times the periods plus one
period's transients, affine in the periods; the peak is the largest
region's, which may move from one region to another as the periods grow
(a laid-out step's update holds every period's gradient blocks, its
backward one period's gathered parameters).
Microbatches (identical too) combine alike: a trace at 2 and one at 3,
linear beyond.  :func:`lengths` makes a long sequence's counts from three
short ones: the recurrent layers' chunks are identical too, and flash
attention runs S / block_kv key blocks of work linear in S when S is a
multiple of its tiles, so at lengths that are multiples of the chunks and
the tiles every count is a polynomial of degree two in the length, fitted
exactly by three traces spaced by such a step.  The peak memory is not: a
short sequence's peak may sit at another point of the step than a long
one's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..kernels import shape_only
from ..sharding import tensor_parallel
from . import roofline

__all__ = ["Cost", "KERNELS", "lengths", "measure", "periods", "with_periods"]

KERNELS = ("lmme", "matrix_scan", "matrix_scan_zero_b", "diag_scan")
MEMORY = ("parameters", "gradients", "state", "activations", "temporaries", "peak",
          "peak_pre", "peak_forward", "peak_loss", "peak_backward", "peak_update")

_aten = torch.ops.aten
_NO_TRAFFIC = {_aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
               _aten.new_empty_strided}
_F32 = (torch.float32, torch.float64)
#: collectives' namespaces: their bytes are the roofline's collective term
#: (``launch/dryrun.py``), not a device's memory traffic
_COLLECTIVES = ("c10d", "_c10d_functional")


@dataclasses.dataclass
class Cost:
    """A step's cost on one device; ``+``, ``-`` and ``* k`` act on every
    number but ``host_s`` and ``n_metrics`` (the left operand's are kept)."""

    flops: float = 0.0        # every FLOP counted, the GOOM kernels' included
    f32_flops: float = 0.0    # of them, those off the tensor cores
    bytes: float = 0.0        # every op's inputs and outputs
    written: float = 0.0      # every op's outputs
    launches: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KERNELS, 0))
    memory: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(MEMORY, 0))
    host_s: float = 0.0
    n_metrics: int = 0        # a train step's metrics reduced over the batch
    #: the model axis's collectives: "kind/group size" -> result bytes summed
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)

    def _map(self, other: Optional["Cost"], fn) -> "Cost":
        o = other if other is not None else Cost()
        keys = sorted(set(self.collectives) | set(o.collectives))
        return Cost(fn(self.flops, o.flops), fn(self.f32_flops, o.f32_flops),
                    fn(self.bytes, o.bytes), fn(self.written, o.written),
                    {k: fn(self.launches[k], o.launches[k]) for k in KERNELS},
                    {k: fn(self.memory[k], o.memory[k]) for k in MEMORY}, self.host_s,
                    self.n_metrics, {k: fn(self.collectives.get(k, 0), o.collectives.get(k, 0))
                                     for k in keys})

    def __add__(self, other: "Cost") -> "Cost":
        return self._map(other, lambda a, b: a + b)

    def __sub__(self, other: "Cost") -> "Cost":
        return self._map(other, lambda a, b: a - b)

    def __mul__(self, k: float) -> "Cost":
        return self._map(None, lambda a, _: a * k)

    @property
    def above_state(self) -> float:
        """The peak less the parameters and the state handed in."""
        return self.memory["peak"] - self.memory["parameters"] - self.memory["state"]


def _work(kernel: str, dims: Dict[str, Any]):
    if kernel == "lmme":
        return roofline.lmme_work(dims["a_shape"], dims["b_shape"])
    if kernel == "diag_scan":
        return roofline.diag_work(dims["t"], dims["c"])
    return roofline.scan_work(dims["t"], dims["g"], dims["d"], dims["m"],
                              has_b=kernel == "matrix_scan", a_fixed=dims["a_fixed"])


def _nbytes(tree) -> int:
    """Bytes of the tensors in ``tree``, each at most its storage's (a
    DTensor's: this rank's block's)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = getattr(t, "_local_tensor", t)
            n = t.numel() * t.element_size()
            total += min(n, t.untyped_storage().nbytes()) if n else 0
    return total


class _Counter(TorchDispatchMode):
    """FLOPs and bytes of every dispatched op, and the GOOM kernels'
    shape-only calls (``on_kernel``)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()

    def on_collective(self, kind: str, nbytes: int, size: int) -> None:
        key = f"{kind}/{size}"
        self.cost.collectives[key] = self.cost.collectives.get(key, 0) + nbytes

    def on_kernel(self, kernel: str, dims: Dict[str, Any]) -> None:
        nbytes, ops = _work(kernel, dims)
        c = self.cost
        c.launches[kernel] += 1
        c.bytes += nbytes
        c.written += nbytes
        c.flops += ops
        c.f32_flops += ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            self.cost.flops += n
            first = next((t for t in tree_leaves(args) if isinstance(t, torch.Tensor)), None)
            if first is not None and first.dtype in _F32:
                self.cost.f32_flops += n
        if not func.is_view and packet not in _NO_TRAFFIC \
                and func.namespace not in _COLLECTIVES:
            w = _nbytes(out)
            n = _nbytes((args, kwargs)) + w
            self.cost.bytes += n
            self.cost.written += w
        return out


class _Leaves:
    """A module's leaf parameters and its buffers, as ``MemTracker`` reads
    a module."""

    def __init__(self, module):
        self._module = module

    def parameters(self):
        return (p for p in self._module.parameters() if isinstance(p, torch.nn.Parameter))

    def buffers(self):
        return self._module.buffers()


#: the parts of a step whose peaks are kept apart (``_tracker``): before the
#: first block, among the blocks in the forward, from the last block's
#: forward to the backward's first block (final norm, loss, head), among
#: the blocks in the backward, and after them (embedding, clip, update)
REGIONS = ("pre", "forward", "loss", "backward", "update")


def _tracker(blocks: Sequence[torch.nn.Module] = ()):
    """A ``MemTracker`` that keeps the whole pass's peak and not each
    module's: the per-module bookkeeping walks every module at every
    allocation, half the host time of a Mamba layer's pass.  A module's
    parameters that are not ``Parameter``s (a laid-out step's gathered
    weights, swapped in for the period) are left where they were counted.
    A second forward of the whole model (the next microbatch) starts the
    modules' stats afresh, where ``MemTracker`` raises.

    With the model's ``blocks`` it also keeps each of ``REGIONS``' peak
    (``region_peaks``), told apart by the blocks' forward and backward
    hooks: over identical periods each region's peak is affine in their
    number, where the whole step's, the largest of them, need not be
    (``periods``)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    block_set = set(map(id, blocks))

    class _PeakOnly(MemTracker):
        def __init__(self):
            super().__init__()
            self.region_peaks: Dict[str, float] = {}
            self._phase, self._inside, self._fw_done, self._bw_done = None, 0, 0, 0

        def _region(self) -> str:
            n = len(block_set)
            if self._phase is None:
                return "pre"
            if self._phase == "fw":
                return "forward" if self._inside or self._fw_done < n else "loss"
            return "backward" if self._bw_done < n else "update"

        def _pre_fw_hook(self, module, inputs) -> None:
            mods = self._mod_tracker
            if module in self.memory_tracking and not mods.is_bw and \
                    set(mods.parents) - {mods.get_known_fqn(module)} == {"Global"}:
                self.reset_mod_stats()
            if id(module) in block_set:
                if mods.is_bw:                    # a period's recomputation
                    self._phase = "bw"
                else:
                    if self._phase == "bw":       # the next microbatch
                        self._fw_done = self._bw_done = 0
                    self._phase, self._inside = "fw", self._inside + 1
            super()._pre_fw_hook(module, inputs)

        def _post_fw_hook(self, module, inputs, outputs) -> None:
            if id(module) in block_set and not self._mod_tracker.is_bw:
                self._inside, self._fw_done = self._inside - 1, self._fw_done + 1
            super()._post_fw_hook(module, inputs, outputs)

        def _pre_bw_hook(self, module, args) -> None:
            if id(module) in block_set:
                self._phase = "bw"
            super()._pre_bw_hook(module, args)

        def _post_bw_hook(self, module, args) -> None:
            if id(module) in block_set:
                self._bw_done += 1
            super()._post_bw_hook(module, args)

        def _track_module_params_and_buffers(self, module, install_grad_hooks=True):
            # a laid-out step's gathered weights stand in for a module's
            # parameters: they stay counted where they were made
            if all(isinstance(p, torch.nn.Parameter) for p in module.parameters()):
                return super()._track_module_params_and_buffers(module, install_grad_hooks)
            return super()._track_module_params_and_buffers(_Leaves(module),
                                                            install_grad_hooks)

        def _update_peak_stats(self, peak_state) -> None:
            total = sum(max(v for k, v in snap.items() if getattr(k, "value", k) == "Total")
                        for snap in self._curr_mem_snap.values())
            if block_set:
                region = self._region()
                self.region_peaks[region] = max(self.region_peaks.get(region, 0), total)
            if not hasattr(self, "_peak_mem_snap"):   # another torch: the whole walk
                return super()._update_peak_stats(peak_state)
            for dev, snap in self._curr_mem_snap.items():
                total = max(v for k, v in snap.items() if getattr(k, "value", k) == "Total")
                if self._peak_mem.get(dev, 0) < total:
                    self._peak_mem[dev] = total
                    self._peak_mem_snap[dev] = dict(snap)

    return _PeakOnly()


def measure(fn: Callable[[], Any], *, modules: Sequence[torch.nn.Module] = (),
            state: Iterable[torch.Tensor] = (), memory: bool = True):
    """(``fn()``, its :class:`Cost`), ``fn`` run once under the counters.
    ``modules``' parameters count as parameters, ``state`` (optimizer
    moments, caches) as state; both must exist before the call.  Without
    ``memory`` the tracker stays off (a third of the host time) and the
    memory is zeros.  Run it inside a ``FakeTensorMode`` to cost a step
    without a device."""
    counter = _Counter()
    blocks = [b for m in modules for b in getattr(m, "layers", ())]
    tracker = _tracker(blocks) if memory else contextlib.nullcontext()
    if memory:
        tracker.track_external(*modules, *state)
    t0 = time.perf_counter()
    with shape_only.listening(counter.on_kernel), \
            tensor_parallel.listening(counter.on_collective), tracker, counter:
        out = fn()
    cost = counter.cost
    cost.host_s = time.perf_counter() - t0
    if not memory:
        return out, cost
    peak = {}
    for snap in tracker.get_tracker_snapshot("peak").values():
        for k, v in snap.items():
            key = getattr(k, "value", k)
            peak[key] = peak.get(key, 0) + v
    cost.memory = {
        "parameters": peak.get("Parameter", 0) + peak.get("Buffer", 0),
        "gradients": peak.get("Gradient", 0),
        "state": peak.get("Optstate", 0) + peak.get("Other", 0),
        "activations": peak.get("Activation", 0),
        "temporaries": peak.get("Temp", 0),
        "peak": peak.get("Total", 0),
        **{f"peak_{r}": tracker.region_peaks.get(r, 0) for r in REGIONS},
    }
    return out, cost


def _regions_peak(c: Cost) -> Cost:
    """``c`` with its peak the largest of its regions' (when it has them)."""
    regions = [c.memory[f"peak_{r}"] for r in REGIONS]
    if any(regions):
        c.memory["peak"] = max(regions)
    return c


def with_periods(cfg, counts: Sequence[int]):
    """``cfg`` with group ``i`` repeated ``counts[i]`` times."""
    groups = tuple(dataclasses.replace(g, n_periods=n) for g, n in zip(cfg.groups, counts))
    n_layers = sum(len(g.period) * g.n_periods for g in groups)
    return dataclasses.replace(cfg, groups=groups, n_layers=n_layers)


def periods(cfg, cost_of: Callable[[Any, int], Cost], microbatches: int = 1) -> Cost:
    """The cost of ``cfg``'s step from traces of one and two periods of each
    group (module docstring); its ``host_s`` is the traces' sum.
    ``cost_of(cfg_k, mb)`` costs the step of ``cfg_k`` at ``mb``
    microbatches of the step's microbatch size; above two microbatches it
    is called at 2 and 3 and the rest extrapolated."""
    ones = [1] * len(cfg.groups)
    traced, at_mb = [], []

    def trace(counts, mb):
        traced.append(cost_of(with_periods(cfg, counts), mb))
        return traced[-1]

    for mb in ((microbatches,) if microbatches <= 2 else (2, 3)):
        base = trace(ones, mb)
        total = base
        for i, group in enumerate(cfg.groups):
            if group.n_periods > 1:
                two = list(ones)
                two[i] = 2
                total = total + (trace(two, mb) - base) * (group.n_periods - 1)
        at_mb.append(total)
    out = at_mb[0] if len(at_mb) == 1 else at_mb[0] + (at_mb[1] - at_mb[0]) * (microbatches - 2)
    out.host_s = sum(c.host_s for c in traced)
    return _regions_peak(out)


def lengths(seq_len: int, cost_at: Callable[[int], Cost], *, base: int, step: int) -> Cost:
    """``cost_at(seq_len)``'s counts, traced as it is up to ``base + 2 step``
    and beyond that fitted by a polynomial of degree two in the length
    through ``cost_at`` at ``base``, ``base + step`` and ``base + 2 step``
    (module docstring; the memory is fitted alike, and is not to be read);
    its ``host_s`` is the traces' sum."""
    xs = [base, base + step, base + 2 * step]
    if seq_len <= xs[-1]:
        return cost_at(seq_len)
    c0, c1, c2 = (cost_at(x) for x in xs)
    u = (seq_len - base) / step          # Newton's form on equal steps
    out = c0 + (c1 - c0) * u + (c2 - c1 * 2 + c0) * (u * (u - 1) / 2)
    out.host_s = c0.host_s + c1.host_s + c2.host_s
    return out
