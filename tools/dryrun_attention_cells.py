"""Dry-run cells that a change moves, costed again and set beside a saved
sweep.

By default the cells attention moves: ``prefill_32k`` of the ten assigned
archs and goom-rnn-124m, and ``train_4k`` of olmo-1b, gemma3-1b and
musicgen-large.  With ``--fsdp``, those the per-period gather moves:
``train_4k`` of the ten assigned archs and goom-rnn-124m, and
``prefill_32k`` of the MoEs and Jamba (whose parameters dominate).  With
``--decode``, ``decode_32k`` of the ten assigned archs and goom-rnn-124m
(laid out a period at a time, their caches under the cell's rules).  Each
on both production meshes (``launch.dryrun``'s cells: the port's real step
on fake tensors, on the CPU; estimates under the H100 datasheet constants,
not card times); merged into ``--out`` and, with ``--before`` (an earlier
sweep's JSON), a table of each cell's peak a device before and after,
whether it fits 80 GB, and its host seconds.  From the repository root:

    PYTHONPATH=src python tools/dryrun_attention_cells.py --workers 4 \\
        --out results/dryrun_torch.json --before OLD.json

Copy ``--out`` aside first to keep the earlier cells as ``--before``; with
``PYTHONPATH`` at another tree's ``src`` it costs that tree's cells.
"""

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import time

from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.launch.dryrun import _run_cell
from repro_torch.launch.roofline import HBM_BYTES

TRAIN_ARCHS = ("olmo-1b", "gemma3-1b", "musicgen-large")
FSDP_PREFILL_ARCHS = ("mixtral-8x7b", "phi3.5-moe", "jamba-v0.1")
GIB = 2 ** 30


def cells(fsdp: bool = False, decode: bool = False):
    archs = list(ASSIGNED_ARCHS) + ["goom-rnn-124m"]
    if decode:
        return [(a, "decode_32k", pod) for pod in (False, True) for a in archs]
    if fsdp:
        return ([(a, "train_4k", pod) for pod in (False, True) for a in archs]
                + [(a, "prefill_32k", pod) for pod in (False, True)
                   for a in FSDP_PREFILL_ARCHS])
    return ([(a, "prefill_32k", pod) for pod in (False, True) for a in archs]
            + [(a, "train_4k", pod) for pod in (False, True) for a in TRAIN_ARCHS])


def _key(d):
    return d["arch"], d["shape"], d["mesh"]


def table(before, after):
    """Markdown rows: arch, shape, mesh, peak GiB before and after, fits."""
    old = {_key(d): d for d in before}
    rows = ["| arch | shape | mesh | peak GiB before | after | fits 80 GB | host s |",
            "|---|---|---|---|---|---|---|"]
    for d in sorted(after, key=_key):
        if "memory_per_device" not in d:
            continue
        was = old.get(_key(d), {}).get("memory_per_device", {}).get("peak_bytes")
        peak = d["memory_per_device"]["peak_bytes"]
        rows.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
                    f"{'—' if was is None else f'{was / GIB:.1f}'} | {peak / GIB:.2f} | "
                    f"{'yes' if peak <= HBM_BYTES else 'no'} | {d['host_s']:.0f} |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--before", default=None)
    ap.add_argument("--fsdp", action="store_true",
                    help="the cells the per-period gather moves (module docstring)")
    ap.add_argument("--decode", action="store_true", help="the decode_32k cells")
    args = ap.parse_args()
    todo = cells(args.fsdp, args.decode)
    t0 = time.time()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.workers, mp_context=ctx) as pool:
        outcomes = list(pool.map(_run_cell, *zip(*todo)))
    keep = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            keep = {_key(d): d for d in json.load(f)}
    done, fails = [], []
    for kind, value in outcomes:
        if kind == "fail":
            fails.append(value)
        else:
            keep[_key(value)] = value
            done.append(value)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(list(keep.values()), f, indent=1)
    print(f"{len(todo)} cells in {time.time() - t0:.0f} s; failures {fails}")
    if args.before:
        with open(args.before) as f:
            print(table(json.load(f), done))
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
