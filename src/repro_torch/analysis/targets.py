"""Trace targets of the graph layer.

The port's copy of ``repro/analysis/targets.py``.  Repo mode walks two
families on fake tensors (``FakeTensorMode``: nothing is allocated, nothing
launched), on the CPU or, with ``device="cuda"``, on fake CUDA tensors:

  * every registered ``(op, backend)`` engine implementation of
    ``kernels/dispatch.py`` (``registered_impls()``), on JAX's small GOOM
    operands: a ``cuda`` implementation takes its wrapper's shape-only
    branch, one opaque kernel step;
  * ``DecoderLM.decode_step`` and ``prefill`` (on fresh caches,
    ``fresh_caches=True``, as JAX's targets) of a recurrent (GOOM-RNN) and
    an attention (OLMo) smoke config, each under the engine's
    ``torch_reference`` backend and under ``cuda`` (on CPU tensors the
    engine is forced to ``cuda``, as ``launch/cost.py`` does).

File mode (the fixture corpus) loads ``GOOMCHECK_TRACES`` from analysed
modules: a list of ``{"name", "fn", "args"}`` dicts where each arg spec is
``(domain, shape, dtype)`` (seeding that domain) or a ``Goom`` of two f32
planes, ``("goom", shape)``.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import pathlib
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from .graph_walker import trace_and_walk
from .lattice import TokenSource, seed_from_spec, seed_tree
from .report import Finding

__all__ = ["TRACED_ARCHS", "TRACED_BACKENDS", "ENGINE_SHAPES", "check_device",
           "port_locator", "run_module_traces", "run_repo_targets"]

TRACED_ARCHS = ("goom-rnn-124m", "olmo-1b")
TRACED_BACKENDS = ("torch_reference", "cuda")
ENGINE_SHAPES = {
    "lmme": ((8, 8), (8, 8)),
    "diagonal_scan": ((16, 8), (16, 8)),
    "matrix_scan": ((16, 4, 4), (16, 4, 4)),
    "cumulative_lmme": ((16, 4, 4),),
}

_PORT = pathlib.Path(__file__).resolve().parents[1]   # src/repro_torch
_ANALYSIS = _PORT / "analysis"


def port_locator(*roots: pathlib.Path) -> Callable[[str], Optional[str]]:
    """``locate(filename)``: the path relative to the first of ``roots``
    that holds it, else relative to ``src/repro_torch`` for the port's own
    files (the analysis package left out), else None."""
    roots = [pathlib.Path(r).resolve() for r in roots]
    cache: Dict[str, Optional[str]] = {}

    def locate(filename: str) -> Optional[str]:
        try:
            return cache[filename]
        except KeyError:
            pass
        rel = None
        p = pathlib.Path(filename)
        if p.is_absolute():
            for root in roots:
                if p.is_relative_to(root):
                    rel = p.relative_to(root).as_posix()
                    break
            else:
                if p.is_relative_to(_PORT) and not p.is_relative_to(_ANALYSIS):
                    rel = p.relative_to(_PORT).as_posix()
        cache[filename] = rel
        return rel

    return locate


def check_device(device: str) -> torch.device:
    """The fake tensors' device; ``cuda`` without a card raises (no fallback)."""
    from ..kernels.dispatch import resolve_device

    return resolve_device(device)


def _plane(shape, device, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _goom(shape, device):
    from ..core.goom import Goom

    return Goom(_plane(shape, device), _plane(shape, device))


def _engine_targets(device):
    """(name, fn, args, scope) per registered (op, backend) impl."""
    from ..kernels import dispatch
    from ..kernels.blocks import default_blocks

    for op, backend in dispatch.registered_impls():
        if op not in ENGINE_SHAPES:
            continue  # a third-party op: no canonical shapes
        impl = dispatch.get_impl(op, backend, blocks=default_blocks(op, backend))
        args = tuple(_goom(s, device) for s in ENGINE_SHAPES[op])
        yield f"{op}/{backend}", impl, args, contextlib.nullcontext()


def _model_targets(archs: Iterable[str], device):
    from ..configs.base import get_config
    from ..core import engine
    from ..models.model import DecoderLM

    for arch in archs:
        cfg = get_config(arch, smoke=True)
        model = DecoderLM(cfg, device=device,
                          generator=torch.Generator(device=device).manual_seed(0))
        model.eval()
        for backend in TRACED_BACKENDS:
            caches = model.init_caches(1, 16)
            token = torch.zeros((1, 1), dtype=torch.long, device=device)
            index = torch.zeros((1,), dtype=torch.long, device=device)
            yield (f"{arch}/decode_step/{backend}", model.decode_step,
                   (token, caches, index), engine.use_backend(backend))
            tokens = torch.zeros((1, 8), dtype=torch.long, device=device)
            fresh = model.init_caches(1, 16)
            yield (f"{arch}/prefill/{backend}",
                   functools.partial(model.prefill, fresh_caches=True), (tokens, fresh),
                   engine.use_backend(backend))


def _stats(name, walk, seconds) -> Dict[str, object]:
    return {"name": name, "ops": walk.ops, "log_values": walk.log_values,
            "kernel_steps": walk.kernel_steps, "findings": len(walk.findings),
            "seconds": seconds}


def run_repo_targets(
    *, archs: Iterable[str] = TRACED_ARCHS, device: str = "cpu",
    locate: Optional[Callable[[str], Optional[str]]] = None,
) -> Tuple[List[Finding], List[str], List[Dict[str, object]]]:
    """Walk every repo target: (findings, skips, per-target stats).  A
    target that fails to build or to run is a skip."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = check_device(device)
    locate = locate or port_locator()
    findings: List[Finding] = []
    skips: List[str] = []
    stats: List[Dict[str, object]] = []
    tokens = TokenSource()

    with FakeTensorMode(), torch.no_grad():
        def targets():
            yield from _engine_targets(dev)
            yield from _model_targets(archs, dev)

        it = targets()
        while True:
            name = "<building targets>"
            try:
                name, fn, args, scope = next(it)
            except StopIteration:
                break
            except Exception as e:   # a target that cannot be built
                skips.append(f"{name}: {type(e).__name__}: {e}")
                break
            t0 = time.perf_counter()
            with scope:
                walk = trace_and_walk(fn, args, seed_tree(args, tokens), target=name,
                                      locate=locate, tokens=tokens)
            findings.extend(walk.findings)
            stats.append(_stats(name, walk, time.perf_counter() - t0))
            if walk.error is not None:
                skips.append(f"{name}: {type(walk.error).__name__}: {walk.error}")
    return findings, skips, stats


# ---------------------------------------------------------------------------
# file mode: GOOMCHECK_TRACES in analysed modules
# ---------------------------------------------------------------------------
def _build_arg(spec, tokens: TokenSource, device):
    """-> (fake arg, its (tensor, AbsVal) seeds)"""
    if spec[0] == "goom":
        g = _goom(spec[1], device)
        return g, seed_tree(g, tokens)
    domain, shape = spec[0], spec[1]
    dtype = getattr(torch, spec[2] if len(spec) > 2 else "float32")
    t = _plane(shape, device, dtype)
    return t, [(t, seed_from_spec(domain, tokens))]


def run_module_traces(
    path: pathlib.Path, rel: str, *, device: str = "cpu",
) -> Tuple[List[Finding], List[str], List[Dict[str, object]]]:
    """Import ``path``; walk every entry of its ``GOOMCHECK_TRACES``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    findings: List[Finding] = []
    skips: List[str] = []
    stats: List[Dict[str, object]] = []
    if "GOOMCHECK_TRACES" not in path.read_text():
        return findings, skips, stats
    dev = check_device(device)
    modname = "goomcheck_torch_fixture_" + rel.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except Exception as e:
        skips.append(f"{rel}: import failed: {type(e).__name__}: {e}")
        return findings, skips, stats

    # corpus root = the analysed path minus its relative suffix
    root = path.resolve().parents[len(pathlib.PurePosixPath(rel).parts) - 1]
    locate = port_locator(root)
    for entry in getattr(mod, "GOOMCHECK_TRACES", []):
        name = f"{rel}:{entry.get('name', entry['fn'].__name__)}"
        tokens = TokenSource()
        t0 = time.perf_counter()
        with FakeTensorMode():
            try:
                built = [_build_arg(s, tokens, dev) for s in entry["args"]]
            except Exception as e:
                skips.append(f"{name}: {type(e).__name__}: {e}")
                continue
            args = tuple(a for a, _ in built)
            seeds = [p for _, ps in built for p in ps]
            walk = trace_and_walk(entry["fn"], args, seeds, target=name,
                                  locate=locate, tokens=tokens)
        findings.extend(walk.findings)
        stats.append(_stats(name, walk, time.perf_counter() - t0))
        if walk.error is not None:
            skips.append(f"{name}: {type(walk.error).__name__}: {walk.error}")
    return findings, skips, stats
