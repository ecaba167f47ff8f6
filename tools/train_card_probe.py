"""chip_smoke.py's training phases alone on the card, and its two ways of
reading a step's device-busy time side by side.

Builds the kernels, then on goom-rnn-124m at full width (``shared_a``,
``remat="none"``, B=16, S=128, bf16) traces one train step with the host's
ops and the card's (``chip_smoke._profiled_device``) and one with the
card's activity alone (``chip_smoke._busy_ms``), printing each one's busy
ms, kernels and seconds taken; then runs ``train_phase``, ``remat_phase``
and ``dist_launcher_phase`` as the script does, with no earlier phase
leaving memory allocated.  Run on a machine with a card, from the
repository root:

    python tools/train_card_probe.py

On an NVIDIA H100 80GB HBM3 at 700.00 W (torch 2.11.0+cu128) the two traces
read 232.586 and 232.833 ms busy in 15.6 and 5.3 s, and ``remat_phase``'s
peaks were 13.35 / 3.35 / 3.56 GiB (``none`` / ``full`` / ``dots``) over
1.27-1.28 GiB allocated at the reset.
"""

import dataclasses
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    from repro_torch import DecoderLM, get_config
    from repro_torch.kernels import build
    from repro_torch.train import make_train_step

    if not torch.cuda.is_available():
        print("train_card_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cs.AUTOTUNE_CACHE
    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = dataclasses.replace(cs.with_scan_variant(get_config("goom-rnn-124m"), "shared_a"),
                              remat="none")
    model = DecoderLM(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(cs.SEED))
    opt, state = cs._train_setup(model)
    step = make_train_step(model, opt)
    batches = list(cs._train_batches(cfg, 3))
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, host_ms, host_n, _ = cs._profiled_device(lambda: step(state, batches[1]))
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_ms, card_n = cs._busy_ms(lambda: step(state, batches[2]))
    card_s = time.perf_counter() - t0
    print(f"trace with the host's ops: {host_ms:.3f} ms busy in {host_n} kernels, "
          f"{host_s:.1f} s; the card's alone: {card_ms:.3f} ms in {card_n}, {card_s:.1f} s",
          flush=True)
    del opt, state, step
    cs.free_memory()
    t0 = time.perf_counter()
    train = cs.train_phase(cfg, model)
    print(f"train_phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cs.remat_phase(cfg, model, train)
    print(f"remat_phase {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    cs.free_memory()
    t0 = time.perf_counter()
    cs.dist_launcher_phase()
    print(f"dist_launcher_phase {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
