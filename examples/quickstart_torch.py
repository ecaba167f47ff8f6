"""Quickstart on the PyTorch port: GOOMs in five minutes, the sections of
``examples/quickstart.py``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

On the card (the default) section 3's chain runs on the zero-B matrix-scan
kernel and section 4 holds the LMME kernel against its plain PyTorch
version; with ``--device cpu`` both are the plain versions.
"""

import argparse

import torch

from repro_torch.core import Goom, engine, from_goom, goom_lse, goom_mul, lmme_reference, to_goom
from repro_torch.kernels.dispatch import resolve_device


def main(argv=None):
    """Runs the five sections; returns what they found: section 4's kernel
    error and section 3's chain (its final log-magnitudes' range)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)

    print("=" * 64)
    print("1. A GOOM is a (log-magnitude, sign) pair — the split form of the")
    print("   paper's complex logarithm x' = log|x| + k·pi·i.")
    x = torch.tensor([2.5, -3.0, 0.0, 1e-30], device=dev)
    g = to_goom(x)
    print("   x        =", x)
    print("   log|x|   =", g.log_abs)
    print("   sign     =", g.sign)
    print("   back     =", from_goom(g))

    print("=" * 64)
    print("2. Products over R are sums over C' (paper Example 1): multiply")
    print("   numbers whose product overflows ANY float format.")
    a = to_goom(torch.full((100,), 1e30, device=dev))
    prod = Goom(a.log_abs.sum(), a.sign.prod())
    print("   log(prod of 100 copies of 1e30) =", float(prod.log_abs),
          "(= 3000·ln 10 — float32 max is ~e^88)")

    print("=" * 64)
    print("3. Matrix products become LMME (paper §3.2).  A chain of 1000")
    print("   random N(0,1) matmuls overflows float32 in ~50 steps; over")
    print("   GOOMs it just runs.")
    mats = torch.randn(1000, 16, 16, generator=gen, device=dev)
    chain = engine.cumulative_lmme(to_goom(mats))  # the zero-B kernel on the card
    final = chain.log_abs[-1]
    found = dict(chain_min=float(final.min()), chain_max=float(final.max()),
                 chain_finite=bool(torch.isfinite(final).all()))
    print("   final log-magnitudes: min %.1f  max %.1f  (finite: %s)" % (
        found["chain_min"], found["chain_max"], found["chain_finite"]))

    print("=" * 64)
    print("4. The CUDA LMME kernel computes the same LMME with per-row and")
    print("   per-column rescaling; the engine picks it on the card, and")
    print("   `use_backend('cuda')` forces it (the plain version on the CPU).")
    a = to_goom(torch.randn(64, 64, generator=gen, device=dev))
    b = to_goom(torch.randn(64, 64, generator=gen, device=dev))
    with engine.use_backend("cuda"):
        out_k = engine.lmme(a, b)
    out_r = lmme_reference(a, b)
    # values over each row's largest: an entry that nearly cancels keeps an
    # error of f32 rounding over its row's scale, not over itself
    m = torch.maximum(out_k.log_abs, out_r.log_abs).amax(-1, keepdim=True)
    found["lmme_err"] = float((from_goom(Goom(out_k.log_abs - m, out_k.sign))
                               - from_goom(Goom(out_r.log_abs - m, out_r.sign))).abs().max())
    found["lmme_log_err"] = float((out_k.log_abs - out_r.log_abs).abs().max())
    print("   max |kernel - reference| over each row's scale:", found["lmme_err"])
    print("   max |kernel - reference| log-mag error:", found["lmme_log_err"])

    print("=" * 64)
    print("5. Dot products are signed log-sum-exp (paper Example 2), stable at")
    print("   magnitudes like e^1000:")
    u = Goom(torch.full((8,), 1000.0, device=dev), torch.ones(8, device=dev))
    v = Goom(torch.full((8,), 1000.0, device=dev), torch.ones(8, device=dev))
    d = goom_lse(goom_mul(u, v), dim=-1)
    print("   log(u·v) =", float(d.log_abs), "(= 2000 + ln 8)")
    print("done.")
    return found


if __name__ == "__main__":
    main()
