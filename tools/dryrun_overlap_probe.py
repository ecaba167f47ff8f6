"""chip_smoke.py's kernel phases with and without one of its host children.

``chip_smoke.py`` starts two children before the build: the dry-run of
goom-rnn-124m's train cells (``start_dryrun``: one thread, no card) and the
port's goomcheck on fake CUDA tensors (``start_goomcheck``: one thread, the
card visible, nothing launched).  This probe builds
the kernels, then runs the kernel phases (``kernel_phase``,
``rwkv6_lmme_phase``, ``scan_kernel_phase``, ``max_d_phase``,
``diag_kernel_phase``) four times: alone, beside a freshly started child,
beside another, alone again.  It prints each run's seconds by phase, how
long the child ran, and for every timed row its device ms (``ms``), CUDA
event ms and host-inclusive ms (``call_ms``) by run, with the median over
the rows of (beside the child) / (alone).  The child starts with the
kernel phases here, after the build, so it overlaps more of them than in
``chip_smoke.py``.  Run on a machine with a card, from the repository root:

    python tools/dryrun_overlap_probe.py [--child dryrun|goomcheck]

The full output goes to ``chiprun_out/<child>_overlap_probe.json``.
"""

import argparse
import json
import os
import pathlib
import statistics
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

RUNS = ("alone", "child", "child", "alone")
KEYS = ("ms", "event_ms", "call_ms")


def kernel_phases():
    """The kernel phases as ``chip_smoke.main`` runs them: (seconds by
    phase, every timed row by name)."""
    seconds, rows = {}, {}
    t0 = time.perf_counter()
    lmme_rows, _ = cs.kernel_phase()
    rows.update({f"lmme {r['shape']}": r for r in lmme_rows})
    rows.update({f"lmme {k}": r for k, r in cs.rwkv6_lmme_phase().items()})
    seconds["lmme"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scan_rows, _ = cs.scan_kernel_phase()
    cs.max_d_phase()
    rows.update({f"scan {k}": r for k, r in scan_rows.items()})
    seconds["scan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    diag_rows, _ = cs.diag_kernel_phase()
    rows.update({f"diag {k}": r for k, r in diag_rows.items()})
    seconds["diag"] = time.perf_counter() - t0
    return seconds, rows


def _watch(proc, t_start: float, out: dict) -> None:
    """Wait for ``proc`` and put its seconds since ``t_start`` in ``out``."""
    proc.wait()
    out["s"] = time.perf_counter() - t_start


def main(argv=None) -> int:
    from repro_torch.kernels import build

    p = argparse.ArgumentParser()
    p.add_argument("--child", choices=("dryrun", "goomcheck"), default="dryrun")
    which = p.parse_args(argv).child
    start, join = ((cs.start_dryrun, cs.join_dryrun) if which == "dryrun"
                   else (cs.start_goomcheck, cs.join_goomcheck))

    if not torch.cuda.is_available():
        print("dryrun_overlap_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cs.AUTOTUNE_CACHE
    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    for kind in RUNS:
        proc = start() if kind == "child" else None
        t_start, child = time.perf_counter(), {}
        if proc is not None:
            threading.Thread(target=_watch, args=(proc, t_start, child), daemon=True).start()
        seconds, rows = kernel_phases()
        if proc is not None:
            join(proc)
        runs.append(dict(kind=kind, seconds=seconds, total_s=sum(seconds.values()),
                         child_s=child.get("s"), rows=rows))
        print(f"run {len(runs)} ({kind}): " + ", ".join(
            f"{k} {v:.1f}" for k, v in seconds.items())
            + f"; total {sum(seconds.values()):.1f} s", flush=True)

    table = {}
    for name in runs[0]["rows"]:
        for key in KEYS:
            vals = [r["rows"].get(name, {}).get(key) for r in runs]
            if all(isinstance(v, float) and v > 0 for v in vals):
                table[f"{name} {key}"] = vals
    ratios = {}
    for key in KEYS:
        per_row = [statistics.mean(v[1:3]) / statistics.mean(v[0::3])
                   for k, v in table.items() if k.endswith(" " + key)]
        if per_row:
            ratios[key] = dict(median=statistics.median(per_row), low=min(per_row),
                               high=max(per_row), rows=len(per_row))
    for name, vals in table.items():
        print(f"{name}: " + " / ".join(f"{v:.4f}" for v in vals), flush=True)
    print(f"beside the {which} child over alone, by row (runs 2-3 over 1 and 4): " + "; ".join(
        f"{k} median {v['median']:.3f} ({v['low']:.3f}-{v['high']:.3f}, {v['rows']} rows)"
        for k, v in ratios.items()) + f"; {card}", flush=True)
    print("phase seconds by run (" + ", ".join(RUNS) + "): " + "; ".join(
        f"{p} " + " / ".join(f"{r['seconds'][p]:.1f}" for r in runs)
        for p in runs[0]["seconds"]) + "; total " + " / ".join(
        f"{r['total_s']:.1f}" for r in runs) + "; the child ran " + " / ".join(
        "-" if r["child_s"] is None else f"{r['child_s']:.1f}"
        for r in runs) + f" s; {card}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / f"{which}_overlap_probe.json", "w") as f:
        json.dump(dict(card=card, child=which, runs=[{k: v for k, v in r.items() if k != "rows"}
                                        for r in runs], table=table, ratios=ratios), f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
