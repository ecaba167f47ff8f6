"""Training launcher: a host mesh of ranks, fault-tolerant loop.

    python -m repro_torch.launch.train --arch goom-rnn-124m --task copy \
        --steps 200 --ckpt-dir ckpt

runs on the card (``--device cuda``, the default; it raises when there is
none) or, with ``--device cpu``, on the CPU through the kernels' plain
versions.  The port of ``repro/launch/train.py``.

**Ranks.**  Under ``python -m torch.distributed.run --nproc-per-node N -m
repro_torch.launch.train ...`` the N ranks join one process group
(``--dist-backend``, ``nccl`` by default; ``gloo`` shares a card, and
carries the collectives of CUDA tensors through its own host copies) and
form a mesh: ``--mesh host`` (the
default), this host's ranks as ("data", "model") of shape
(N / M, M), M the ``--seq-shards`` or ``--model-shards`` count; ``--mesh production`` and
``production-multipod``, JAX's (16, 16) and (2, 16, 16), which need a world
of 256 and 512 ranks and refuse any other, naming the world they need
(``launch/mesh.py``).  Rank r runs on ``cuda:{local_rank % device_count}``.

On a mesh of several ranks the parameters are laid out as DTensors by the
rules (``sharding.distribute_model``, JAX's ``param_shardings``), the
optimizer's moments as their parameters and the step replicated
(``state_placements``, JAX's ``state_shardings``), and the batch is split
over the rules' batch axes (``batch_placements``, JAX's
``batch_shardings``): the rank at index i of those axes draws slice i of
the global batch (``process_index``).  The model gathers one period's
parameters at a time and the gradients go back into their layout
(``train/train_loop.py``, ``sharding/gather.py``), on the port's own
collectives, which gloo carries for CUDA tensors too: gloo ranks that
share a card lay their parameters out as well.
``--seq-shards`` maps the ``scan_seq`` logical axis to "model": every
recurrent layer time-shards its scan over the rank's seq group, each rank
building and holding its ⌈T/P⌉ steps (``sharding/layout.py``).
Whatever sizes the model axis, the rules split the attention heads, the
dense MLP's channels and the vocabulary (the embedding and the head) on it,
as JAX's do (``sharding/tensor_parallel.py``); with ``--model-shards M``
(a (world / M, M) host mesh, no time shards) the goom layer's heads and
Mamba's channels split too, where under ``--seq-shards`` those layers keep
whole heads and time-shard.
Checkpoints hold whole tensors in the JAX layout, gathered from every
rank and written by rank 0, and restore at any rank count.

The time shards' collectives are DTensor's (``constrain``), which gloo
cannot carry for CUDA tensors (on an H100 under torch 2.11 the ranks die
with SIGSEGV; ``tools/dtensor_gloo_probe.py``).  So gloo ranks that share
a card with ``--seq-shards`` > 1 keep the plain layout: the parameters
whole on every rank, the gradients averaged over the data group by hand,
and each scan of the seq group run on the full-length operands
(``engine.use_mesh``, ``kernels/sharded.py``).  Rank 0 alone logs.  NCCL
takes one rank a card: more ranks than cards under NCCL are refused (pass
``--dist-backend gloo`` to share a card).  ``--metrics-out``: rank 0
writes every step's metrics and, for each rank, its kernel launches, its
engine calls, and its peak device memory over the steps after the first
(``torch.cuda.max_memory_allocated``; over the one step of a run of one)
with the bytes allocated when the peak was reset (``floor_bytes``: the
state, and what the first calls allocated for good, such as cuBLAS's
workspace); nulls on the CPU.

``--autotune`` sweeps the kernels' launch knobs on the training shapes
before the first step (rank 0; the others read its cache).
``--grad-compression int8`` rounds the averaged gradients through int8.

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
import contextlib
import dataclasses
import itertools
import json
import math
import os
import signal
import sys
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config
from ..core import engine
from ..kernels.dispatch import BACKENDS, resolve_device
from ..launch.mesh import make_host_mesh, make_production_mesh
from ..models.model import DecoderLM
from ..sharding.layout import placements
from ..sharding.mesh import NamedMesh
from ..sharding.rules import distribute_model, make_rules, param_placements, use_rules
from ..train.checkpoint import CheckpointManager
from ..train.data import DataConfig, Prefetcher, SyntheticStream
from ..train.optimizer import AdamW, cosine_schedule
from ..train.train_loop import (TrainState, init_train_state, load_state_tree, make_train_step,
                                state_tree)


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
    ap.add_argument("--mesh", default="host",
                    choices=["host", "production", "production-multipod"],
                    help="host: this host's ranks as a (data, model) mesh; production: "
                         "(16, 16) over 256 ranks; production-multipod: (2, 16, 16) "
                         "over 512")
    ap.add_argument("--seq-shards", type=int, default=1,
                    help="time-shard every GOOM scan over this many ranks (the "
                         "mesh's model axis); 1 = off")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="split heads, MLP and Mamba channels and the vocabulary over "
                         "this many ranks (the mesh's model axis, no time shards); "
                         "1 = off")
    ap.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                    help="process-group backend under torch.distributed.run")
    ap.add_argument("--autotune", action="store_true",
                    help="sweep the kernels' launch knobs on the training shapes "
                         "first and persist the winners (kernels/autotune.py)")
    ap.add_argument("--grad-compression", default=None, choices=["int8"])
    ap.add_argument("--compute-dtype", default=None, choices=["bfloat16", "float32"],
                    help="the model's compute dtype (default: the config's)")
    ap.add_argument("--metrics-out", default=None,
                    help="rank 0 writes every step's metrics and each rank's kernel "
                         "launches, engine calls and peak device memory here as JSON")
    ap.add_argument("--straggler-factor", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _init_ranks(args) -> torch.device:
    """Join the process group when started by torch.distributed.run, and
    the device this rank runs on."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = resolve_device(args.device)
    if world == 1:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        if args.dist_backend == "nccl" and local_world > n_cards:
            raise RuntimeError(
                f"--dist-backend nccl: {local_world} ranks on {n_cards} card(s), and "
                "NCCL refuses two ranks on one card; pass --dist-backend gloo to "
                "share a card")
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    elif args.dist_backend == "nccl":
        raise RuntimeError("--dist-backend nccl needs --device cuda")
    dist.init_process_group(args.dist_backend)
    return dev


def main(argv=None):
    """Train; returns (model, final TrainState, metrics of the last step)."""
    args = parse_args(argv)
    dev = _init_ranks(args)
    try:
        return _train(args, dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _mesh(args, dev) -> NamedMesh:
    if args.seq_shards > 1 and args.model_shards > 1:
        raise ValueError("--seq-shards and --model-shards both size the model axis; "
                         "pass one of them")
    if args.mesh == "host":
        return make_host_mesh(seq_shards=args.seq_shards * args.model_shards,
                              device_type=dev.type)
    mesh = make_production_mesh(multi_pod=args.mesh.endswith("multipod"),
                                device_type=dev.type)
    if mesh.device_mesh is None:   # as jax.make_mesh, refuse another world
        world = dist.get_world_size() if dist.is_initialized() else 1
        raise ValueError(f"--mesh {args.mesh} {dict(mesh.shape)} needs a world of "
                         f"{math.prod(mesh.shape.values())} ranks; this one has {world}")
    if max(args.seq_shards, args.model_shards) > 1 and \
            mesh.shape["model"] != max(args.seq_shards, args.model_shards):
        raise ValueError(f"--seq-shards/--model-shards must equal the production "
                         f"mesh's model axis ({mesh.shape['model']})")
    return mesh


def state_placements(rules, model, state: TrainState) -> Dict[str, Any]:
    """JAX's ``state_shardings``: each moment laid out as its parameter
    (``param_placements``), the optimizer's and the state's step replicated
    (None: a Python int on every rank)."""
    pl = param_placements(rules, model)
    opt = {k: (None if k == "step" else dict(pl)) for k in state.opt_state}
    return {"params": pl, "opt_state": opt, "step": None}


def batch_placements(rules) -> tuple:
    """JAX's ``batch_shardings`` for tokens and labels (B, S): the batch over
    the rules' batch axes, the sequence whole."""
    spec = rules.spec((math.prod(rules.mesh.shape.values()), 1), ("batch", None))
    return placements(rules.mesh.axis_names, spec)


def batch_slice(rules, mesh: NamedMesh) -> Tuple[int, int]:
    """(index, count) of this rank's slice of the global batch under
    :func:`batch_placements`: the rank's position over the mesh dims that
    split dim 0, major first."""
    idx, count = 0, 1
    for d, pl in enumerate(batch_placements(rules)):
        if getattr(pl, "dim", None) == 0:
            name = mesh.axis_names[d]
            size = mesh.shape[name]
            idx = idx * size + (mesh.get_local_rank(name) if mesh.device_mesh else 0)
            count *= size
    return idx, count


def _memory_floor(dev: torch.device):
    """The bytes allocated on the card now, its peak reset to them (None on
    the CPU)."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def uses_layouts(args, dev: torch.device, multi: bool) -> bool:
    """Whether a run lays its parameters out as DTensors: on a mesh of
    several ranks wherever the process group carries the step's
    collectives.  The gathers are the port's own, which gloo carries for
    CUDA tensors too; the time shards' are DTensor's, which gloo does not
    (the module docstring)."""
    return multi and (dev.type == "cpu" or args.dist_backend == "nccl"
                      or args.seq_shards == 1)


def _train(args, dev):
    mesh = _mesh(args, dev)
    rank = dist.get_rank() if dist.is_initialized() else 0
    multi = mesh.device_mesh is not None
    layouts = uses_layouts(args, dev, multi)
    rules = make_rules(mesh, overrides={"scan_seq": "model"} if args.seq_shards > 1 else None)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=getattr(torch, args.compute_dtype))
    model = DecoderLM(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(args.seed))
    if layouts:
        distribute_model(model, rules)
    opt = AdamW(cosine_schedule(args.lr, args.warmup, args.steps))
    state = init_train_state(model, opt)
    data_group = (mesh.get_group("data") if multi and not layouts and mesh.shape["data"] > 1
                  else None)
    step_fn = make_train_step(model, opt, microbatches=args.microbatches,
                              grad_compression=args.grad_compression, data_group=data_group,
                              rules=rules if layouts else None)
    index, count = batch_slice(rules, mesh)
    stream = SyntheticStream(DataConfig(
        task=args.task, vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.batch,
        seed=args.seed, process_index=index, process_count=count))
    # gloo ranks sharing a card: the scans of the seq group on full-length
    # operands, since the time shards' collectives are DTensor's
    scans = (engine.use_mesh(mesh, seq_axis="model", batch_axis="data")
             if multi and not layouts and args.seq_shards > 1 else contextlib.nullcontext())

    if args.autotune:
        if rank == 0:
            # the training shapes, as the JAX launcher's; the cache is bucketed
            with engine.use_backend(args.backend):
                engine.autotune(shapes={
                    "diagonal_scan": (args.seq_len, cfg.d_model),
                    "matrix_scan": (args.seq_len, 16, 16),
                    "cumulative_lmme": (args.seq_len, 16),
                    "lmme": (args.seq_len, cfg.d_model, cfg.d_model)}, verbose=True)
        if multi:
            dist.barrier()
            from ..kernels import autotune

            autotune.load_cache(reload=True)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if mgr is not None:
        restored = mgr.restore_latest(state_tree(cfg, state))   # every rank reads
        if restored is not None:
            start_step, tree, extra = restored
            state = load_state_tree(cfg, state, tree)
            stream.load_state_dict(extra.get("data", {"step": start_step}))
            if rank == 0:
                print(f"resumed from checkpoint step {start_step}", flush=True)

    # preemption: checkpoint at the end of the step in flight, then exit
    preempted = {"flag": False}

    def on_sigterm(sig, frame):
        preempted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, on_sigterm)
    writer = mgr if rank == 0 else None   # rank 0 alone writes checkpoints

    def save(step_no):
        # DTensor leaves are gathered by every rank; rank 0 writes
        tree = state_tree(cfg, state) if (writer is not None or layouts) else None
        if writer is not None:
            writer.save(step_no, tree, extra={"data": {"step": step_no}})
    batches = Prefetcher(itertools.islice(stream, args.steps - start_step), dev)
    metrics, times, history = None, [], []
    floor = _memory_floor(dev)
    t_start = time.perf_counter()
    try:
        with use_rules(rules), engine.use_backend(args.backend), scans:
            for step, batch in zip(range(start_step, args.steps), batches):
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                if step == start_step and args.steps - start_step > 1:
                    floor = _memory_floor(dev)   # the first calls' allocations made
                if args.metrics_out and rank == 0:
                    history.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
                if rank == 0 and (step % args.log_every == 0 or step == args.steps - 1):
                    m = {k: float(v) for k, v in metrics.items()}
                    print(f"step {step:5d}  loss {m['loss']:.4f}  ce {m['ce_loss']:.4f}  "
                          f"gnorm {m['grad_norm']:.3f}  "
                          f"{(time.perf_counter() - t0) * 1e3:.0f} ms", flush=True)
                times.append(time.perf_counter() - t0)
                if len(times) > 20:
                    med = float(np.median(times[-20:]))
                    if times[-1] > args.straggler_factor * med:
                        print(f"[straggler-watch] rank {rank} step {step} took "
                              f"{times[-1]:.2f}s vs median {med:.2f}s", flush=True)
                if args.ckpt_dir and ((step + 1) % args.ckpt_every == 0
                                      or preempted["flag"]):
                    save(step + 1)
                    if preempted["flag"]:
                        if writer is not None:
                            writer.wait()
                            print(f"preempted: checkpointed at step {step + 1}",
                                  flush=True)
                        sys.exit(0)
        if mgr is not None:
            save(args.steps)
            if writer is not None:
                writer.wait()
    finally:
        batches.close()
        signal.signal(signal.SIGTERM, old_handler)
    if args.metrics_out:
        from ..serve.graphs import kernel_launches

        mine = {"launches": kernel_launches(), "calls": dict(engine.calls),
                "peak_bytes": (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                               else None), "floor_bytes": floor}
        ranks = [mine]
        if multi:
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, mine)
        if rank == 0:
            with open(args.metrics_out, "w") as f:
                json.dump({"steps": history, "launches": mine["launches"],
                           "world": dist.get_world_size() if multi else 1,
                           "layouts": layouts, "ranks": ranks}, f)
    if rank == 0:
        print(f"done: {args.steps - start_step} steps in "
              f"{time.perf_counter() - t_start:.1f}s", flush=True)
    return model, state, metrics


if __name__ == "__main__":
    main()
