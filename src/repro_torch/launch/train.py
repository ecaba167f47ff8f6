"""Training launcher: one device, fault-tolerant loop.

    python -m repro_torch.launch.train --arch goom-rnn-124m --task copy \
        --steps 200 --ckpt-dir ckpt

runs on the card (``--device cuda``, the default; it raises when there is
none) or, with ``--device cpu``, on the CPU through the kernels' plain
versions.  The port of ``repro/launch/train.py`` without meshes, sequence
sharding, autotuning or gradient compression.

Fault tolerance (see ``train/checkpoint.py``):
  * a checkpoint every ``--ckpt-every`` steps, atomic and asynchronous;
  * on start, auto-resume from the latest COMPLETE checkpoint, data cursor
    included (no replayed or skipped batches);
  * SIGTERM (preemption) makes the loop write a checkpoint at the end of
    the step in flight and exit.

Straggler watch: a step slower than ``--straggler-factor`` times the median
of the last 20 is reported.
"""

from __future__ import annotations

import argparse
import itertools
import signal
import sys
import time

import numpy as np
import torch

from ..configs import get_config
from ..core import engine
from ..kernels.dispatch import BACKENDS, resolve_device
from ..models.model import DecoderLM
from ..train.checkpoint import CheckpointManager
from ..train.data import DataConfig, Prefetcher, SyntheticStream
from ..train.optimizer import AdamW, cosine_schedule
from ..train.train_loop import init_train_state, load_state_tree, make_train_step, state_tree


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="goom-rnn-124m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--task", default="markov", choices=["markov", "copy"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--backend", default="auto", choices=list(BACKENDS),
                    help="engine backend for every GOOM op (auto: the CUDA "
                         "kernels on the card, the plain versions on the CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--straggler-factor", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns (model, final TrainState, metrics of the last step)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = DecoderLM(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(args.seed))
    opt = AdamW(cosine_schedule(args.lr, args.warmup, args.steps))
    state = init_train_state(model, opt)
    step_fn = make_train_step(model, opt, microbatches=args.microbatches)
    stream = SyntheticStream(DataConfig(task=args.task, vocab=cfg.vocab,
                                        seq_len=args.seq_len, global_batch=args.batch,
                                        seed=args.seed))

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if mgr is not None:
        restored = mgr.restore_latest(state_tree(cfg, state))
        if restored is not None:
            start_step, tree, extra = restored
            state = load_state_tree(cfg, state, tree)
            stream.load_state_dict(extra.get("data", {"step": start_step}))
            print(f"resumed from checkpoint step {start_step}", flush=True)

    # preemption: checkpoint at the end of the step in flight, then exit
    preempted = {"flag": False}

    def on_sigterm(sig, frame):
        preempted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, on_sigterm)
    batches = Prefetcher(itertools.islice(stream, args.steps - start_step), dev)
    metrics, times = None, []
    t_start = time.perf_counter()
    try:
        with engine.use_backend(args.backend):
            for step, batch in zip(range(start_step, args.steps), batches):
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                if step % args.log_every == 0 or step == args.steps - 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    print(f"step {step:5d}  loss {m['loss']:.4f}  ce {m['ce_loss']:.4f}  "
                          f"gnorm {m['grad_norm']:.3f}  "
                          f"{(time.perf_counter() - t0) * 1e3:.0f} ms", flush=True)
                times.append(time.perf_counter() - t0)
                if len(times) > 20:
                    med = float(np.median(times[-20:]))
                    if times[-1] > args.straggler_factor * med:
                        print(f"[straggler-watch] step {step} took {times[-1]:.2f}s "
                              f"vs median {med:.2f}s", flush=True)
                if mgr is not None and ((step + 1) % args.ckpt_every == 0
                                        or preempted["flag"]):
                    mgr.save(step + 1, state_tree(cfg, state),
                             extra={"data": {"step": step + 1}})
                    if preempted["flag"]:
                        mgr.wait()
                        print(f"preempted: checkpointed at step {step + 1}", flush=True)
                        sys.exit(0)
        if mgr is not None:
            mgr.save(args.steps, state_tree(cfg, state), extra={"data": {"step": args.steps}})
            mgr.wait()
    finally:
        batches.close()
        signal.signal(signal.SIGTERM, old_handler)
    print(f"done: {args.steps - start_step} steps in "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)
    return model, state, metrics


if __name__ == "__main__":
    main()
