"""goomcheck CLI: ``python -m repro_torch.analysis [paths...] [--ci] [--json F]``.

Two modes, as ``python -m repro.analysis``:

* **repo mode** (no paths): AST rules over ``src/repro_torch/**``, the
  GC205 registry-completeness check, and the graph layer over the
  registered engine impls and the models' decode/prefill targets.
* **file mode** (explicit paths): AST rules over the given files/dirs,
  plus graph traces for any module defining ``GOOMCHECK_TRACES`` (how the
  known-bad fixture corpus is exercised).

Exit status is 0 when no *non-suppressed* finding is left, else 1.
``--json`` writes the full report (suppressed findings, trace skips and
each target's counts).  ``--device cuda`` walks fake CUDA tensors: it needs
a card, and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional

from . import analyze_paths, analyze_repo, repo_root
from .report import AnalysisResult, format_text, to_json

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="goomcheck for the port: GOOM numerical-safety + "
                    "architecture linter")
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: the whole port)")
    p.add_argument("--ci", action="store_true",
                   help="machine-oriented summary line (exit code gates)")
    p.add_argument("--json", metavar="FILE", default=None,
                   help="write the JSON findings report here")
    p.add_argument("--no-trace", action="store_true",
                   help="skip the graph layer (AST rules only)")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                   help="device of the fake tensors the graph layer walks")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="also print suppressed findings, trace skips and "
                        "each target's counts")
    args = p.parse_args(argv)

    trace = not args.no_trace
    if args.paths:
        result: AnalysisResult = analyze_paths(
            [pathlib.Path(x) for x in args.paths], trace=trace, device=args.device)
    else:
        result = analyze_repo(trace=trace, device=args.device)

    if args.json:
        out = pathlib.Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(to_json(result))

    print(format_text(result, verbose=args.verbose))
    if args.ci:
        mode = "repo" if not args.paths else "paths"
        status = "clean" if result.ok else "FAILED"
        print(f"goomcheck --ci [{mode} mode, device={args.device}, "
              f"root={repo_root()}]: {status}")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
