"""goomcheck for the port: static analysis enforcing GOOM numerical-safety
and engine-architecture invariants on ``src/repro_torch``.

The port's counterpart of ``repro/analysis`` (same rule ids, suppression
syntax and CLI), with two layers:

* a **graph layer** (``graph_walker`` + ``lattice``): an abstract
  interpreter over the aten ops that the registered engine impls and the
  models' serving entry points dispatch on fake tensors, checking
  log-space discipline (GC1xx);
* an **AST layer** (``rules_ast``): the repo's structural conventions in
  torch's names (GC2xx).

Run as ``python -m repro_torch.analysis`` (repo mode) or import the pieces
from tests.  Findings support line-scoped ``# goomcheck: disable=RULE``
suppression comments.
"""

from __future__ import annotations

import pathlib
from typing import Iterable, List, Tuple

from .graph_walker import Walk, trace_and_walk
from .lattice import AbsVal, TokenSource, join, seed_tree
from .registry import RULES, Rule
from .report import (AnalysisResult, Finding, apply_suppressions, dedup,
                     format_text, to_json)
from .rules_ast import check_registry, run_ast_rules, run_source
from .targets import TRACED_ARCHS, check_device, run_module_traces, run_repo_targets

__all__ = [
    "AbsVal", "AnalysisResult", "Finding", "RULES", "Rule", "TokenSource",
    "TRACED_ARCHS", "Walk", "analyze_paths", "analyze_repo",
    "apply_suppressions", "check_registry", "dedup", "format_text", "join",
    "repo_root", "run_ast_rules", "run_module_traces", "run_repo_targets",
    "run_source", "seed_tree", "to_json", "trace_and_walk",
]


def repo_root() -> pathlib.Path:
    """The repository root (this file lives at src/repro_torch/analysis/)."""
    return pathlib.Path(__file__).resolve().parents[3]


def _iter_py(paths: Iterable[pathlib.Path]) -> List[Tuple[pathlib.Path, str]]:
    out = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            out.extend((f, f.relative_to(p).as_posix())
                       for f in sorted(p.rglob("*.py")))
        else:
            out.append((p, p.name))
    return out


def analyze_repo(*, trace: bool = True, device: str = "cpu") -> AnalysisResult:
    """Repo mode: AST over src/repro_torch, GC205, and the graph targets
    on fake tensors of ``device``."""
    check_device(device)
    root = repo_root()
    src = root / "src" / "repro_torch"
    findings = run_ast_rules(
        (f, f.relative_to(src).as_posix())
        for f in sorted(src.rglob("*.py")))

    from ..kernels import dispatch
    from ..kernels.blocks import OPS

    findings.extend(check_registry(
        OPS, dispatch.registered_impls(), root / "tests"))

    skips: List[str] = []
    targets: List[dict] = []
    if trace:
        traced, skips, targets = run_repo_targets(device=device)
        findings.extend(traced)
    findings = apply_suppressions(dedup(findings), [src, root])
    return AnalysisResult(findings=findings, skips=skips, targets=targets)


def analyze_paths(paths: Iterable[pathlib.Path], *, trace: bool = True,
                  device: str = "cpu") -> AnalysisResult:
    """File mode: AST rules + GOOMCHECK_TRACES over explicit paths."""
    check_device(device)
    paths = [pathlib.Path(p) for p in paths]
    files = _iter_py(paths)
    findings = run_ast_rules(files)
    skips: List[str] = []
    targets: List[dict] = []
    if trace:
        for f, rel in files:
            traced, s, t = run_module_traces(f, rel, device=device)
            findings.extend(traced)
            skips.extend(s)
            targets.extend(t)
    roots = [p if p.is_dir() else p.parent for p in paths]
    roots.append(pathlib.Path(__file__).resolve().parents[1])   # the port's files
    findings = apply_suppressions(dedup(findings), roots)
    return AnalysisResult(findings=findings, skips=skips, targets=targets)
