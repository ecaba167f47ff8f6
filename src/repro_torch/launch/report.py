"""Render the dry-run's markdown tables from a sweep's JSON.

The port of ``repro/launch/report.py``, against the H100's 80 GB.  Usage:

  PYTHONPATH=src python -m repro_torch.launch.report [--compact] [results/dryrun_torch.json]

prints a summary and one table a mesh, or with ``--compact`` one table with
a row a cell of every mesh side by side (PERF.md embeds that).  Every
number is an estimate under the datasheet constants (``launch/roofline.py``),
not a time measured on a card.
"""

from __future__ import annotations

import json
import sys

GIB = 2 ** 30
HBM = 80e9   # launch/roofline.py HBM_BYTES


def fmt_bytes(b):
    return f"{b/GIB:.2f}"


def _peak(r) -> float:
    return (r.get("memory_per_device") or {}).get("peak_bytes", 0.0)


def render(path: str) -> str:
    with open(path) as f:
        rows = json.load(f)
    rows.sort(key=lambda r: (r["mesh"], r["arch"], r["shape"]))

    out = []
    for mesh in sorted({r["mesh"] for r in rows}):
        out.append(f"\n### Mesh {mesh} "
                   f"({'single-pod 256 GPUs' if mesh == '16x16' else '2 pods / 512 GPUs'})\n")
        out.append(
            "| arch | shape | peak GiB (of 80 GB) | compute ms | memory ms | "
            "collective ms | bottleneck | useful | MFU | host s |")
        out.append("|---|---|---|---|---|---|---|---|---|---|")
        for r in [r for r in rows if r["mesh"] == mesh]:
            if "skipped" in r:
                out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                           f"SKIP (full attention @500k) | — | — | — |")
                continue
            over = " (over)" if _peak(r) > HBM else ""
            out.append(
                f"| {r['arch']} | {r['shape']} | {fmt_bytes(_peak(r))}{over} | "
                f"{r['compute_s']*1e3:.2f} | {r['memory_s']*1e3:.2f} | "
                f"{r['collective_s']*1e3:.2f} | {r['bottleneck']} | "
                f"{r['useful_fraction']:.2f} | {r['mfu']*100:.2f}% | {r.get('host_s', 0):.1f} |")
    return "\n".join(out)


def compact(path: str) -> str:
    """One row an (arch, shape), each field "mesh a / mesh b" in mesh order;
    the skipped cells on one line."""
    with open(path) as f:
        rows = json.load(f)
    meshes = sorted({r["mesh"] for r in rows})
    cells = {}
    for r in rows:
        cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    skipped = sorted({a for (a, _), by in cells.items()
                      if all("skipped" in r for r in by.values())})

    def field(by, fn):
        return " / ".join(fn(by[m]) if m in by else "—" for m in meshes)

    out = [f"Meshes: {' / '.join(meshes)}.",
           "| arch | shape | peak GiB (of 80 GB) | compute ms | memory ms | collective ms "
           "| bottleneck | useful | MFU % | host s |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), by in sorted(cells.items()):
        if any("skipped" in r for r in by.values()):
            continue
        out.append("| " + " | ".join([
            arch, shape,
            field(by, lambda r: fmt_bytes(_peak(r)) + ("*" if _peak(r) > HBM else "")),
            field(by, lambda r: f"{r['compute_s'] * 1e3:.1f}"),
            field(by, lambda r: f"{r['memory_s'] * 1e3:.1f}"),
            field(by, lambda r: f"{r['collective_s'] * 1e3:.1f}"),
            field(by, lambda r: r["bottleneck"]),
            field(by, lambda r: f"{r['useful_fraction']:.3f}"),
            field(by, lambda r: f"{r['mfu'] * 100:.2f}"),
            field(by, lambda r: f"{r.get('host_s', 0):.0f}")]) + " |")
    if skipped:
        out.append(f"\nSkipped at long_500k (pure full attention): {', '.join(skipped)}. "
                   "`*`: over the card's 80 GB.")
    return "\n".join(out)


def summary(path: str) -> str:
    with open(path) as f:
        rows = json.load(f)
    live = [r for r in rows if "skipped" not in r]
    skips = [r for r in rows if "skipped" in r]
    over = [r for r in live if _peak(r) > HBM]
    by_bn = {}
    for r in live:
        by_bn[r["bottleneck"]] = by_bn.get(r["bottleneck"], 0) + 1
    lines = [
        f"- {len(live)} costed cells, {len(skips)} documented skips "
        f"(pure full-attention archs × long_500k).",
        f"- Cells over the 80 GB HBM budget: {len(over)}"
        + (": " + ", ".join(f"{r['arch']}×{r['shape']}×{r['mesh']}" for r in over)
           if over else "."),
        "- Bottleneck mix: " + ", ".join(f"{k}: {v}" for k, v in sorted(by_bn.items())),
        f"- Host seconds: {sum(r.get('host_s', 0) for r in live):.0f} over every cell.",
    ]
    return "\n".join(lines)


if __name__ == "__main__":
    args = sys.argv[1:]
    p = next((a for a in args if not a.startswith("--")), "results/dryrun_torch.json")
    print(summary(p))
    print(compact(p) if "--compact" in args else render(p))
