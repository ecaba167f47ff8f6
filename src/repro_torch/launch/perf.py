"""Perf iteration: cost one cell with a set of optimizations, record
its three roofline terms, and append them to ``results/perf_log.json``.

The port of ``repro/launch/perf.py`` over ``launch/dryrun.py`` (fake
tensors on the host: no card needed).  Usage:

  PYTHONPATH=src python -m repro_torch.launch.perf --arch codeqwen1.5-7b \\
      --shape train_4k --tag it1_bf16cast --perf cast_params_bf16
  PYTHONPATH=src python -m repro_torch.launch.perf --arch gemma3-1b \\
      --shape train_4k --tag it1_banded --perf banded --perf microbatches=4
"""

from __future__ import annotations

import argparse
import json
import os

from .dryrun import lower_cell
from .mesh import make_production_mesh


def parse_perf(items):
    perf = {}
    for it in items or []:
        if "=" in it:
            k, v = it.split("=", 1)
            try:
                v = int(v)
            except ValueError:
                pass
            perf[k] = v
        else:
            perf[it] = True
    return perf


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--perf", action="append", default=[])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/perf_log.json")
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    perf = parse_perf(args.perf)
    rf = lower_cell(args.arch, args.shape, mesh, perf=perf)

    entry = rf.to_dict()
    entry.update(tag=args.tag, perf=perf)
    log = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            log = json.load(f)
    log.append(entry)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(log, f, indent=1)

    # deltas against the first entry recorded for the same cell
    prior = [e for e in log[:-1]
             if e["arch"] == rf.arch and e["shape"] == rf.shape and e["mesh"] == rf.mesh]
    if prior:
        base = prior[0]
        print(f"\nvs first recorded ({base['tag']}):")
        for term in ("compute_s", "memory_s", "collective_s"):
            b, n = base[term], entry[term]
            print(f"  {term}: {b*1e3:9.2f} ms -> {n*1e3:9.2f} ms "
                  f"({(n / b - 1) * 100 if b else 0.0:+.1f}%)")
        print(f"  MFU: {base['mfu']:.4f} -> {entry['mfu']:.4f}")
    return entry


if __name__ == "__main__":
    main()
