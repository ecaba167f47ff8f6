"""Findings, suppression handling, and output formatting for goomcheck.

The port's copy of ``repro/analysis/report.py``.  A :class:`Finding` pins a
rule violation to ``file:line``.  Suppression is line-scoped: a
``# goomcheck: disable=GC202`` comment on the reported line (or on the line
immediately above, for multi-line expressions and standalone justification
comments) marks the finding suppressed; the comment must name the rule (or
say ``all``).  Suppressed findings stay in the report (``"suppressed":
true`` in the JSON) but do not gate.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
from typing import Dict, Iterable, List, Optional

__all__ = ["Finding", "AnalysisResult", "apply_suppressions", "dedup",
           "format_text", "to_json"]

# the directive may sit anywhere in a comment ("# goomcheck: disable=GC202"
# or appended to a note: "# max-rescaled; goomcheck: disable=GC202")
_DISABLE_RE = re.compile(
    r"goomcheck:\s*disable=((?:GC\d+)(?:\s*,\s*GC\d+)*|all)")


@dataclasses.dataclass
class Finding:
    rule: str            # "GC101", ...
    file: str            # repo-relative (or corpus-relative) posix path
    line: int            # 1-indexed; 0 = whole-file finding
    message: str
    severity: str = "error"
    target: Optional[str] = None  # graph trace target that produced it
    suppressed: bool = False

    def key(self):
        return (self.rule, self.file, self.line)

    def __str__(self):
        sup = " [suppressed]" if self.suppressed else ""
        tgt = f" (trace: {self.target})" if self.target else ""
        return (f"{self.file}:{self.line}: {self.rule} [{self.severity}] "
                f"{self.message}{tgt}{sup}")


@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]
    skips: List[str]  # trace targets that could not be built/traced
    # one dict a traced target: name, ops walked, log values, kernel steps,
    # findings, seconds
    targets: List[Dict[str, object]] = dataclasses.field(default_factory=list)

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def ok(self) -> bool:
        return not self.active


def _disabled_rules(line: str) -> Optional[set]:
    m = _DISABLE_RE.search(line)
    if not m:
        return None
    spec = m.group(1)
    if spec == "all":
        return {"all"}
    return {r.strip() for r in spec.split(",")}


def apply_suppressions(findings: Iterable[Finding],
                       roots: Iterable[pathlib.Path]) -> List[Finding]:
    """Mark findings whose source line carries a matching disable comment.

    ``roots`` are tried in order to resolve each finding's relative path.
    """
    roots = list(roots)
    cache: Dict[str, List[str]] = {}
    out = []
    for f in findings:
        lines = cache.get(f.file)
        if lines is None:
            lines = []
            for root in roots:
                p = root / f.file
                if p.exists():
                    lines = p.read_text().splitlines()
                    break
            cache[f.file] = lines
        for ln in (f.line, f.line - 1):  # the line itself, then the one above
            if 1 <= ln <= len(lines):
                rules = _disabled_rules(lines[ln - 1])
                if rules and ("all" in rules or f.rule in rules):
                    f = dataclasses.replace(f, suppressed=True)
                    break
        out.append(f)
    return out


def dedup(findings: Iterable[Finding]) -> List[Finding]:
    """Drop duplicate (rule, file, line) triples (e.g. one site traced
    through several engine backends), keeping the first occurrence."""
    seen, out = set(), []
    for f in findings:
        if f.key() not in seen:
            seen.add(f.key())
            out.append(f)
    return out


def format_text(result: AnalysisResult, *, verbose: bool = False) -> str:
    lines = []
    shown = result.findings if verbose else result.active
    for f in sorted(shown, key=lambda f: (f.file, f.line, f.rule)):
        lines.append(str(f))
    if verbose:
        for s in result.skips:
            lines.append(f"skip: {s}")
        for t in result.targets:
            lines.append("trace: {name}: {ops} ops, {log_values} log values, "
                         "{kernel_steps} kernel steps, {findings} findings, "
                         "{seconds:.2f} s".format(**t))
    n_active = len(result.active)
    n_sup = len(result.findings) - n_active
    lines.append(f"goomcheck: {n_active} finding(s), {n_sup} suppressed, "
                 f"{len(result.skips)} trace target(s) skipped, "
                 f"{len(result.targets)} traced")
    return "\n".join(lines)


def to_json(result: AnalysisResult) -> str:
    return json.dumps(
        {
            "findings": [dataclasses.asdict(f) for f in result.findings],
            "skips": result.skips,
            "targets": result.targets,
            "ok": result.ok,
        },
        indent=2,
    )
