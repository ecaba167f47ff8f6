"""Per-op launch-knob autotuner with a persisted JSON cache.

The port's counterpart of ``repro/kernels/autotune.py``.  It sweeps the
candidate knobs of an ``(op, backend)`` pair on a representative problem,
times each, and persists the winners keyed by

    ``op | backend | device_kind | shape-bucket | algo``

``device_kind`` is ``torch.cuda.get_device_name(0)`` on a machine with a
card, else ``"cpu"``; the bucket rounds each dim up to a power of two
(``blocks.shape_bucket``); ``algo`` is the time-axis variant the entry's
blocks pin (``seq``, ``chunked``, ``-`` for ops without one).  One sweep
writes the best blocks of each algo and the overall winner under the
reserved slot ``best``, which is what :func:`cached_blocks` (and so
``dispatch.get_impl``) resolves.

The candidates are the knobs the port's kernels take at run time:

  * with-B matrix scan on ``cuda``: the powers of two L whose
    K = ceil(T / L) chunks fit the block (16 at d <= 16, 4 at d <= 32, as
    ``with_b_chunk_len`` says), and L = T (``algo="seq"``); above d = 32 a
    block walks time whatever L, so L = T alone;
  * zero-B matrix scan (``cumulative_lmme``) on ``cuda``: the powers of two
    L from 2 below T (its scratch holds K - 1 chunk products at any L) and
    L = T;
  * ``lmme`` and ``diagonal_scan`` on ``cuda``: one candidate, the default,
    because their tiles are constexpr; the entry records its time;
  * ``torch_reference``: the chunk of the plain matrix scan (JAX's
    xla_reference candidates), one candidate for the other ops.

A candidate that fails to launch is recorded with its error.  On the card a
candidate is timed, after a warm-up call, on the device: ``GRAPH_CALLS``
calls captured in a CUDA graph, the median of ``GRAPH_REPLAYS`` replays
between two events (``graph_time_ms``).  A call the graph cannot capture is
recorded with the capture's error, as a candidate that fails to launch.
CUDA events around eager calls shorter than their launch time the host,
and a plain sum of a profiler trace's records loses the short launches
the profiler drops: either let the 64-token chunk's winner flip between
card runs.  On the CPU a candidate is timed with ``perf_counter``.

Cache file (JSON)::

    {"version": 2, "entries": {"<key>": {"blocks": {...}, "ms": t,
                                         "candidates": n}, ...}}

A file of another version, or a key that is not 5-part, is ignored.  The
cache is the port's own: ``$REPRO_TORCH_AUTOTUNE_CACHE``, else
``~/.cache/repro_torch/autotune.json``; once a path has been loaded or
written it sticks for path-less reads.  The user-facing entry point is
``repro_torch.core.engine.autotune()``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.goom import Goom
from .blocks import OPS, BlockConfig, default_blocks, merge, shape_bucket

__all__ = ["autotune_op", "cached_blocks", "candidates_for", "cache_path",
           "load_cache", "save_entry", "device_kind", "cache_key", "DEFAULT_SHAPES"]

_VERSION = 2

#: representative problem dims per op when the caller gives none (JAX's)
DEFAULT_SHAPES: Dict[str, Tuple[int, ...]] = {
    "lmme": (512, 512, 512),          # (n, d, m)
    "diagonal_scan": (4096, 512),     # (t, c)
    "matrix_scan": (512, 16, 16),     # (t, d, m)
    "cumulative_lmme": (512, 16),     # (t, d)
}


def cache_path() -> str:
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


@functools.lru_cache(maxsize=None)
def device_kind() -> str:
    from .dispatch import current_platform   # dispatch imports this module

    return torch.cuda.get_device_name(0) if current_platform() == "cuda" else "cpu"


def cache_key(op: str, backend: str, bucket: Tuple[int, ...],
              kind: Optional[str] = None, algo: str = "best") -> str:
    """The 5-part key; ``algo`` is a variant name, ``-`` for ops without one,
    or the reserved ``best`` slot that resolution reads."""
    kind = device_kind() if kind is None else kind
    return f"{op}|{backend}|{kind}|{'x'.join(map(str, bucket))}|{algo}"


_CACHE: Optional[Dict[str, dict]] = None   # None: not loaded yet
_CACHE_FILE: Optional[str] = None


def load_cache(path: Optional[str] = None, *, reload: bool = False) -> Dict[str, dict]:
    """The entries, loaded once per process (or per explicit path).  The path
    sticks: once a file has been loaded or written, path-less reads use it."""
    global _CACHE, _CACHE_FILE
    path = path or _CACHE_FILE or cache_path()
    if _CACHE is not None and _CACHE_FILE == path and not reload:
        return _CACHE
    entries: Dict[str, dict] = {}
    try:
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict) and data.get("version") == _VERSION:
            entries = {k: v for k, v in dict(data.get("entries", {})).items()
                       if k.count("|") == 4}
    except (OSError, ValueError):
        pass   # missing, corrupt or of another version: start empty
    _CACHE, _CACHE_FILE = entries, path
    return entries


def save_entry(key: str, blocks: BlockConfig, ms: float, n_candidates: int,
               path: Optional[str] = None) -> None:
    """Insert or overwrite one entry and write the whole cache atomically."""
    path = path or _CACHE_FILE or cache_path()
    entries = load_cache(path)
    entries[key] = {"blocks": blocks.to_dict(), "ms": ms, "candidates": n_candidates}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": _VERSION, "entries": entries}, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def cached_blocks(op: str, backend: str,
                  shapes: Optional[Tuple[int, ...]] = None) -> BlockConfig:
    """The winner persisted for the shape bucket, merged over the default;
    the default when there is none."""
    base = default_blocks(op, backend)
    if shapes is None:
        return base
    entry = load_cache().get(cache_key(op, backend, shape_bucket(shapes)))
    if not entry:
        return base
    known = {f.name for f in dataclasses.fields(BlockConfig)}
    return merge(base, BlockConfig(**{k: v for k, v in entry.get("blocks", {}).items()
                                      if k in known}))


def _pow2(lo: int, hi: int) -> List[int]:
    out, v = [], lo
    while v <= hi:
        out.append(v)
        v *= 2
    return out


def candidates_for(op: str, backend: str, shapes: Tuple[int, ...]) -> List[BlockConfig]:
    """The knobs to sweep for one (op, backend) on a problem of ``shapes``
    (see the module docstring)."""
    if backend == "cuda" and op in ("matrix_scan", "cumulative_lmme"):
        t, d = shapes[0], shapes[1]
        if op == "matrix_scan":
            kmax = 16 if d <= 16 else 4 if d <= 32 else 0
            chunks = [ell for ell in _pow2(2, t - 1) if -(-t // ell) <= kmax]
        else:
            chunks = _pow2(2, t - 1)
        return [BlockConfig(block_t=ell, algo="chunked") for ell in chunks] + \
            [BlockConfig(algo="seq")]
    if backend == "torch_reference" and op in ("matrix_scan", "cumulative_lmme"):
        t = shapes[0]
        tiles = [32, 64, 128, 256]
        return [BlockConfig(block_t=v) for v in
                ([v for v in tiles if v <= max(16, 2 * t)] or [min(tiles)])]
    return [BlockConfig()]


def _example_args(op: str, shapes: Tuple[int, ...], device) -> Tuple[Goom, ...]:
    gen = torch.Generator().manual_seed(0)

    def g(*shape, scale=0.5):
        v = torch.randn(shape, generator=gen) * scale
        return Goom(v.abs().log().to(device), v.sign().to(device))

    if op == "lmme":
        n, d, m = shapes
        return g(n, d), g(d, m)
    if op == "diagonal_scan":
        t, c = shapes
        a = -torch.randn(t, c, generator=gen).abs()
        return Goom(a.to(device), torch.ones(t, c, device=device)), g(t, c)
    if op == "matrix_scan":
        t, d, m = shapes
        return g(t, d, d), g(t, d, m)
    if op == "cumulative_lmme":
        t, d = shapes
        return (g(t, d, d),)
    raise ValueError(f"unknown op {op!r}; one of {OPS}")


#: calls a candidate's CUDA graph holds, and the graph's timed replays
GRAPH_CALLS, GRAPH_REPLAYS = 20, 5


def graph_time_ms(fn, calls: int = GRAPH_CALLS, replays: int = GRAPH_REPLAYS) -> float:
    """Device time per call of ``fn()``: ``calls`` calls captured in one CUDA
    graph (after a warm-up call on a side stream), the median over
    ``replays`` replays of the time between two CUDA events around one
    replay, over ``calls``.  A replay launches every kernel from the device's
    queue, so the host's launch rate, which leads a call of microseconds, is
    left out; the gaps between a graph's kernels (a microsecond or two) stay
    in.  Raises what the capture raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def _time_call(fn, args, reps: int, cuda: bool) -> float:
    """ms a call: on the card the device time of a replayed CUDA graph of
    calls (``graph_time_ms``, raising what the capture raises); on the CPU
    the wall time of ``reps`` calls."""
    fn(*args)   # warm-up: builds and loads the kernel
    if cuda:
        return graph_time_ms(lambda: fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps * 1e3


def autotune_op(op: str, backend: str, shapes: Optional[Tuple[int, ...]] = None, *,
                candidates: Optional[Sequence[BlockConfig]] = None, reps: int = 3,
                path: Optional[str] = None, device=None, verbose: bool = False) -> dict:
    """Sweep the candidates of ``(op, backend)`` on ``device`` (the card for
    ``cuda``, else the CPU) and persist the winners.  Returns the winner,
    its ms, the table of every candidate (its ms or its error) and the key
    written."""
    from . import dispatch   # dispatch imports this module

    shapes = tuple(shapes or DEFAULT_SHAPES[op])
    dev = torch.device(device or ("cuda" if backend == "cuda" else "cpu"))
    args = _example_args(op, shapes, dev)
    base = default_blocks(op, backend)
    cands = list(candidates or candidates_for(op, backend, shapes))
    table: List[dict] = []
    best: Tuple[float, BlockConfig] = (float("inf"), base)
    best_by_algo: Dict[str, Tuple[float, BlockConfig]] = {}
    with torch.no_grad():
        for cand in cands:
            blocks = merge(base, cand)
            fn = dispatch.get_impl(op, backend, blocks)
            try:
                ms = _time_call(fn, args, reps, dev.type == "cuda")
            except (RuntimeError, ValueError) as e:   # a knob the launch (or a capture) refuses
                table.append({"blocks": blocks.to_dict(), "error": repr(e)})
                continue
            table.append({"blocks": blocks.to_dict(), "ms": ms})
            if verbose:
                print(f"  {op}/{backend} {shapes} {blocks.to_dict()} -> {ms:.4f} ms",
                      flush=True)
            if ms < best[0]:
                best = (ms, blocks)
            algo = cand.algo or "-"
            if algo not in best_by_algo or ms < best_by_algo[algo][0]:
                best_by_algo[algo] = (ms, blocks)
    if not best_by_algo:
        raise RuntimeError(f"autotune: no candidate for ({op}, {backend}) ran; errors: "
                           f"{[r.get('error') for r in table]}")
    bucket = shape_bucket(shapes)
    for algo, (ms_a, blk_a) in best_by_algo.items():
        save_entry(cache_key(op, backend, bucket, algo=algo), blk_a, ms_a, len(cands),
                   path=path)
    key = cache_key(op, backend, bucket)
    save_entry(key, best[1], best[0], len(cands), path=path)
    return {"op": op, "backend": backend, "shapes": shapes, "key": key,
            "blocks": best[1].to_dict(), "ms": best[0], "table": table}
