"""Fixed-shape serving steps captured once as CUDA graphs and replayed.

The port's counterpart of ``jax.jit`` with donated buffers.  A step is a
Python function that reads and writes a fixed set of tensors in place (the
static tokens, positions, termination state and caches, and buffers for its
outputs) and returns nothing.  ``StepGraphs.run(name, fn, *args)``:

  * on the CPU calls ``fn(*args)`` eagerly, because the caller asked for the
    CPU (its tensors lie there);
  * on ``cuda``, the first time it sees ``name`` over these tensors (their
    addresses, shapes, strides and dtypes), runs ``fn`` once uncaptured on a
    side stream, which builds the kernels' libraries, sets their shared
    memory attributes and warms cuBLAS and the allocator, then puts every
    tensor argument back to its state before that run and captures ``fn``
    into a graph; every call, the first included, replays the graph.  A
    failure to capture or to replay raises: there is no eager fallback.

Every call runs inside the engine scope of ``StepGraphs(backend, mesh=,
seq_shards=, blocks=)`` (``steps._engine_scope``), so one graph is one
backend and one set of launch knobs, as one jitted step is in JAX.  All
graphs of one ``StepGraphs`` share one memory pool: a step's temporaries
live there, and the steps run one after another on one stream.

**Under a mesh.**  A step whose scans are time-sharded holds collectives
(``kernels.sharded.collectives`` moves during its warm-up run), and a
replayed graph cannot hold a collective that goes through the host.  Such a
step is never captured: its warm-up run stands as its first call and every
later call runs eagerly.  Steps whose scans stay local (a decode step,
T = 1 below the shard count) are captured as ever.  ``captured()`` says
which step ran which way (``"mode"``: ``"graph"`` or ``"eager"``).

Replays move no Python counter, so each graph records what its capture
counted (the kernels' launch counts and the engine's op calls) and each
replay adds that to the module's ``replayed`` totals: the launches of a run
are the wrappers' counts plus ``replayed["launches"]``, its engine calls
``engine.calls`` plus ``replayed["calls"]``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from ..core import engine
from ..kernels import sharded
from ..kernels.goom_scan import diagonal_scan_cuda, matrix_scan_cuda
from ..kernels.lmme import lmme_cuda

__all__ = ["StepGraphs", "kernel_launches", "replayed", "reset_replays"]

#: launches and engine calls that graph replays made since ``reset_replays``
replayed: Dict[str, Dict[str, int]] = {"launches": {}, "calls": {}}


def reset_replays() -> None:
    replayed["launches"] = {}
    replayed["calls"] = {}


def kernel_launches() -> Dict[str, int]:
    """Each CUDA kernel's launch count, as its wrapper keeps it."""
    return {"lmme": lmme_cuda.launches, "matrix_scan": matrix_scan_cuda.launches,
            "matrix_scan_zero_b": matrix_scan_cuda.launches_zero_b,
            "diag_scan": diagonal_scan_cuda.launches}


def _leaves(tree: Any, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    return out


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


class _Captured:
    __slots__ = ("graph", "launches", "calls", "replays")

    def __init__(self, graph, launches, calls):
        self.graph = graph            # None: the step holds collectives, eager
        self.launches = launches      # kernel launches one replay makes
        self.calls = calls            # engine op calls one replay stands for
        self.replays = 0              # calls served (replays, or eager runs)


class StepGraphs:
    """The captured steps of one serving engine (see the module docstring)."""

    def __init__(self, backend: str = "auto", *, mesh=None, seq_shards="auto",
                 blocks=None):
        self.backend = backend
        self.mesh, self.seq_shards, self.blocks = mesh, seq_shards, blocks
        self._graphs: Dict[Tuple, _Captured] = {}
        self._pool = None

    def scope(self):
        """The engine scope every call of a step runs in."""
        from .steps import _engine_scope

        return _engine_scope(self.backend, self.mesh, self.seq_shards, self.blocks)

    @property
    def n_graphs(self) -> int:
        return sum(g.graph is not None for g in self._graphs.values())

    def captured(self) -> Dict[str, Dict[str, Any]]:
        """Per step name: ``"graph"`` or ``"eager"`` (a step that holds
        collectives), what one replay launches and calls, and the calls
        served."""
        out: Dict[str, Dict[str, Any]] = {}
        for key, g in self._graphs.items():
            out[key[0]] = {"mode": "eager" if g.graph is None else "graph",
                           "launches": dict(g.launches), "calls": dict(g.calls),
                           "replays": g.replays}
        return out

    def run(self, name: str, fn: Callable[..., None], *args) -> None:
        leaves = _leaves(args, [])
        if not leaves or leaves[0].device.type != "cuda":
            with self.scope():
                fn(*args)
            return
        key = (name,) + tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                              for t in leaves)
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(fn, args, leaves)
            self._graphs[key] = g
            if g.graph is None:   # the warm-up run was this call
                g.replays += 1
                return
        if g.graph is None:
            with self.scope():
                fn(*args)
            g.replays += 1
            return
        g.graph.replay()
        g.replays += 1
        for kind, counts in (("launches", g.launches), ("calls", g.calls)):
            tot = replayed[kind]
            for k, v in counts.items():
                tot[k] = tot.get(k, 0) + v

    def _capture(self, fn, args, leaves) -> _Captured:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        saved = [t.clone() for t in leaves]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        before = sharded.collectives["n"]
        with torch.cuda.stream(side), self.scope():
            fn(*args)                                    # the warm-up run
        torch.cuda.current_stream().wait_stream(side)
        if sharded.collectives["n"] != before:   # time-sharded: keep it eager
            return _Captured(None, {}, {})
        for t, s in zip(leaves, saved):
            t.copy_(s)
        del saved
        launches0, calls0 = kernel_launches(), dict(engine.calls)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"), self.scope():
            fn(*args)
        return _Captured(graph, _delta(kernel_launches(), launches0),
                         _delta(dict(engine.calls), calls0))
