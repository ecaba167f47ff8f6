"""Parallel Lyapunov-spectrum estimation (paper §4.2) on the PyTorch port,
the run of ``examples/lyapunov_spectra.py``.

Run:  PYTHONPATH=src python examples/lyapunov_spectra_torch.py [--steps 4096]
      [--chunk 256] [--device cpu]

Estimates the full spectrum of each in-repo dynamical system two ways:
  * sequential iterative QR (the standard method, eq. 19-20);
  * the paper's parallel algorithm: a prefix scan over GOOMs with selective
    resetting of near-colinear deviation states (§4.2.1, §5), its products
    on the LMME kernel on the card;
and the largest exponent by PSCAN(LMME) (eq. 24), on the zero-B matrix-scan
kernel.  The systems' rollouts (a sequential loop of tiny steps) run on the
CPU; their Jacobians move to the device.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.lyapunov import (
    SYSTEMS, lle_parallel, spectrum_parallel, spectrum_sequential,
    trajectory_and_jacobians,
)
from repro_torch.kernels.dispatch import resolve_device


def _timed(fn, dev):
    """(result, wall seconds), the device synchronised around the call."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None):
    """Returns each system's spectra (sorted, largest first), LLE and wall
    seconds: {name: {"ref", "seq", "par", "lle", "t_seq", "t_par", "t_lle"}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a first call of each estimator (kernel libraries load on first use)
    warm = torch.eye(2, device=dev).expand(8, 2, 2)
    spectrum_parallel(warm, 1.0, chunk_size=4)
    lle_parallel(warm, 1.0)

    out = {}
    for name, system in SYSTEMS.items():
        _, js = trajectory_and_jacobians(system, args.steps, device="cpu")
        js = js.to(dev)
        s_seq, t_seq = _timed(lambda: spectrum_sequential(js, system.dt), dev)
        s_par, t_par = _timed(
            lambda: spectrum_parallel(js, system.dt, chunk_size=args.chunk), dev)
        l_par, t_lle = _timed(lambda: lle_parallel(js, system.dt), dev)
        s_seq = np.sort(s_seq.cpu().numpy())[::-1]
        s_par = np.sort(s_par.cpu().numpy())[::-1]
        ref = np.sort(np.asarray(system.ref_spectrum))[::-1]
        out[name] = dict(ref=ref, seq=s_seq, par=s_par, lle=float(l_par),
                         t_seq=t_seq, t_par=t_par, t_lle=t_lle)
        print(f"\n{name} ({args.steps} steps, dt={system.dt}):")
        print(f"  literature : {np.array2string(ref, precision=3)}")
        print(f"  sequential : {np.array2string(s_seq, precision=3)}  "
              f"({t_seq*1e3:.0f} ms)")
        print(f"  parallel   : {np.array2string(s_par, precision=3)}  "
              f"({t_par*1e3:.0f} ms)")
        print(f"  LLE (eq.24): {float(l_par):.4f}  ({t_lle*1e3:.0f} ms)")
    return out


if __name__ == "__main__":
    main()
