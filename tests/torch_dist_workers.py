"""Rank functions for the port's multi-process tests (gloo on the CPU).

``repro_torch.launch.mesh.spawn_ranks`` starts each rank in a fresh process
that imports its function by module path, so the functions live here, in a
module that imports no JAX: the ranks load only torch and the port.  Inputs
and results are numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.goom import Goom
from repro_torch.core.scan import colinearity_select, orthonormal_reset
from repro_torch.launch.mesh import make_host_mesh


def _one_thread():
    """Ranks share the host's cores: one intra-op thread each."""
    torch.set_num_threads(1)


def _g(pair):
    return None if pair is None else Goom(torch.tensor(pair[0]), torch.tensor(pair[1]))


def _np(g: Goom):
    return g.log_abs.detach().numpy(), g.sign.detach().numpy()


def _grads(a, b, x0):
    """d(sum of finite state logs) / d(log a), d(log b), as test_sharded's."""
    al = a.log_abs.clone().requires_grad_()
    bl = b.log_abs.clone().requires_grad_()
    out = engine.matrix_scan(Goom(al, a.sign), Goom(bl, b.sign), x0)
    torch.where(torch.isfinite(out.log_abs), out.log_abs, 0.0).sum().backward()
    return al.grad.numpy(), bl.grad.numpy()


def _run_case(op, args, extra):
    if op == "grad":
        return _grads(*args)
    if op == "reset":
        states, flags = engine.selective_reset_scan(
            args[0], colinearity_select(extra), orthonormal_reset())
        return _np(states) + (flags.numpy(),)
    return _np(getattr(engine, op)(*args))


def sharded_cases(rank, p, cases, batch_case=None):
    """Each case ``name -> (op, operand pairs, extra)`` under the (1, p) host
    mesh; with ``batch_case`` (p = 4) also a matrix scan under a (2, 2)
    ("data", "seq") mesh whose data rank takes its half of the batch.
    Returns ``name -> numpy results`` and the shard count each case saw."""
    _one_thread()
    mesh = make_host_mesh(seq_shards=p)
    out = {}
    with engine.use_mesh(mesh):
        out["_shards"] = engine.active_seq_shards()
        for name, (op, pairs, extra) in cases.items():
            out[name] = _run_case(op, [_g(x) for x in pairs], extra)
    if batch_case is not None:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.sharding.mesh import NamedMesh

        dm = NamedMesh.of(init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "seq")))
        i = dm.get_local_rank("data")
        a, b = (_g(x) for x in batch_case)
        half = a.shape[1] // 2
        with engine.use_mesh(dm, seq_axis="seq", batch_axis="data"):
            out["_batch_shards"] = engine.active_seq_shards()
            out["_batch"] = (i, _np(engine.matrix_scan(a[:, i * half:(i + 1) * half],
                                                       b[:, i * half:(i + 1) * half])))
    return out


def _smoke_model(arch, variant=None, periods=None):
    from repro_torch import DecoderLM, get_config

    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=torch.float32)
    if variant is not None:
        from torch_parity import with_scan_variant

        cfg = with_scan_variant(cfg, variant)
    return DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def serve_tokens(model, mesh=None):
    """The smoke model's Engine tokens over three requests (prompts of 1, 9
    and 21 tokens, chunk 8), and ``generate``'s over a batch of 2 prompts
    of 12 tokens, under ``mesh`` (None: local)."""
    from repro_torch import Engine, Request
    from repro_torch.serve.steps import generate

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, model.cfg.vocab, size=n).tolist(),
                    max_new_tokens=5) for i, n in enumerate([1, 9, 21])]
    eng = Engine(model, max_slots=2, page_len=64, chunk=8, mesh=mesh)
    served = eng.run(reqs)
    prompt = torch.tensor(rng.integers(0, model.cfg.vocab, size=(2, 12)))
    gen = generate(model, prompt, 6, 32, mesh=mesh).numpy()
    return served, gen


def serve_rank(rank, models):
    """``serve_tokens`` of each smoke model (arch, variant) under the (1, 2)
    mesh, with the shard count the engine saw."""
    _one_thread()
    mesh = make_host_mesh(seq_shards=2)
    out = {}
    for arch, variant in models:
        with engine.use_mesh(mesh):
            shards = engine.active_seq_shards()
        out[(arch, variant)] = serve_tokens(_smoke_model(arch, variant), mesh) + (shards,)
    return out


# ---------------------------------------------------------------------------
# DTensor layouts: train steps, time shards, checkpoints across rank counts
# ---------------------------------------------------------------------------
def _train_model(variant="shared_a", seq=32, seed=0):
    model = _smoke_model("goom-rnn-124m", variant)
    from repro_torch.train import AdamW, cosine_schedule

    return model, AdamW(cosine_schedule(3e-3, 1, 4))


def global_batch(step: int, count: int, seq: int = 32, batch: int = 4):
    """The global batch of ``step`` when ``count`` ranks draw a slice each
    (what one process trains on to match them): the slices in rank order."""
    from repro_torch.train import DataConfig, SyntheticStream

    parts = [SyntheticStream(DataConfig(task="copy", vocab=256, seq_len=seq,
                                        global_batch=batch, process_index=i,
                                        process_count=count)).generate(step)
             for i in range(count)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _rank_batch(rules, mesh, step, seq=32, batch=4):
    """This rank's slice of the global batch under the launcher's
    ``batch_placements``."""
    from repro_torch.launch.train import batch_slice
    from repro_torch.train import DataConfig, SyntheticStream
    from repro_torch.train.data import to_device

    index, count = batch_slice(rules, mesh)
    b = SyntheticStream(DataConfig(task="copy", vocab=256, seq_len=seq, global_batch=batch,
                                   process_index=index, process_count=count)).generate(step)
    return to_device(b, "cpu")


def _layout_run(shape, steps, variant="shared_a", seq_shards=False, restore=None,
                save=None):
    """``steps`` f32 train steps of goom-rnn smoke with the parameters laid
    out by the rules over a ``shape`` ("data", "model") mesh (and
    ``scan_seq`` on "model" with ``seq_shards``), after restoring the
    checkpoint in ``restore`` if given; saves one in ``save`` (rank 0
    writes) after the steps.  Returns each step's metrics and, on rank 0,
    the whole parameters after the last."""
    import torch.distributed as dist

    from repro_torch.core import engine as eng
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.sharding import distribute_model, make_rules, use_rules
    from repro_torch.train import (CheckpointManager, init_train_state, load_state_tree,
                                   make_train_step, state_tree)

    mesh = _device_mesh(shape, ("data", "model"), "cpu")
    rules = make_rules(mesh, overrides={"scan_seq": "model"} if seq_shards else None)
    model, opt = _train_model(variant)
    distribute_model(model, rules)
    state = init_train_state(model, opt)
    start = 0
    if restore is not None:
        start, tree, _ = CheckpointManager(restore).restore_latest(state_tree(model.cfg, state))
        state = load_state_tree(model.cfg, state, tree)
    step = make_train_step(model, opt, rules=rules)
    rows = []
    with use_rules(rules), eng.use_backend("torch_reference"):
        for i in range(start, start + steps):
            state, m = step(state, _rank_batch(rules, mesh, i))
            rows.append({k: float(v) for k, v in m.items()})
    tree = state_tree(model.cfg, state)
    if save is not None and dist.get_rank() == 0:
        mgr = CheckpointManager(save)
        mgr.save(state.step, tree, extra={"data": {"step": state.step}})
        mgr.wait()
    dist.barrier()
    params = {n: p.full_tensor().detach().numpy() for n, p in model.named_parameters()}
    params = params if dist.get_rank() == 0 else None
    placements = {n: str(p.placements) for n, p in model.named_parameters()}
    from repro_torch.launch.train import state_placements

    want = state_placements(rules, model, state)
    moments = all(tuple(state.opt_state[k][n].placements) == tuple(want["opt_state"][k][n])
                  for k in ("mu", "nu") for n in want["params"])
    return {"rows": rows, "params": params, "placements": placements,
            "moments_follow": moments and want["opt_state"]["step"] is None}


def _time_shard_capture(seq):
    """Layer 0's time-sharded scan (``generic`` goom-rnn smoke, f32, batch
    of 2 and ``seq`` tokens) under a (1, 2) mesh's rules with ``scan_seq``
    on "model": the shapes of the operands and states the rank's
    ``matrix_scan_shard`` saw, its states, and the full-length path's states
    of the same layer under ``engine.use_mesh``."""
    from repro_torch.kernels import sharded
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.sharding import make_rules, use_rules

    model, _ = _train_model("generic")
    mesh = _device_mesh((1, 2), ("data", "model"), "cpu")
    rules = make_rules(mesh, overrides={"scan_seq": "model"})
    tokens = torch.as_tensor(np.random.default_rng(seq).integers(0, 256, (2, seq)))
    seen = []
    body = sharded.matrix_scan_shard

    def spy(a_l, b_l, x0, **kw):
        out = body(a_l, b_l, x0, **kw)
        seen.append((tuple(a_l.shape), tuple(b_l.shape), tuple(out.shape), _np(out)))
        return out

    sharded.matrix_scan_shard = spy
    try:
        with torch.no_grad(), use_rules(rules):
            logits_ts = model(tokens).numpy()
        first_ts = seen[0]
        seen.clear()
        with torch.no_grad(), use_rules(rules), engine.use_mesh(mesh, seq_axis="model"):
            logits_full = model(tokens).numpy()
        full_states = seen[0]
    finally:
        sharded.matrix_scan_shard = body
    return {"time_shard": first_ts, "full": full_states, "logits_ts": logits_ts,
            "logits_full": logits_full}


def _jamba_time_shards(seq=21):
    """Jamba smoke (f32, ``goom``) on a batch of 2 and ``seq`` tokens: the
    loss and every gradient under a (1, 2) mesh's rules with ``scan_seq`` on
    "model" (each rank scans its ⌈seq/2⌉ steps of every Mamba layer) and
    without rules, on the same weights."""
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.sharding import make_rules, use_rules

    model = _smoke_model("jamba-v0.1")
    mesh = _device_mesh((1, 2), ("data", "model"), "cpu")
    rules = make_rules(mesh, overrides={"scan_seq": "model"})
    rng = np.random.default_rng(seq)
    tokens = torch.as_tensor(rng.integers(0, model.cfg.vocab, (2, seq)))
    labels = torch.as_tensor(rng.integers(0, model.cfg.vocab, (2, seq)))
    out = {}
    for name, scope in (("local", None), ("time_shards", rules)):
        engine.reset_calls()
        with use_rules(scope):
            loss, _ = model.loss(tokens, labels)
            params = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, list(params.values()))
        out[name] = (float(loss.detach()), {n: g.numpy() for n, g in zip(params, grads)},
                     dict(engine.calls))
    return out


def layouts_world2(rank, ckpt_dir):
    """On 2 gloo ranks: a step at (2, 1) (FSDP: batch and "embed" over
    data) and at (1, 2) (the model axis's splits, the batch whole), a
    ``--seq-shards 2`` step at (1, 2) and the time shards of one layer at
    S = 32 and 31; then 2 steps at (2, 1) saved to ``ckpt_dir`` and the
    third step's metrics (the next loss a restore must give)."""
    _one_thread()
    out = {"fsdp": _layout_run((2, 1), 1), "tp": _layout_run((1, 2), 1),
           "seq": _layout_run((1, 2), 1, variant="generic", seq_shards=True),
           "shards": {s: _time_shard_capture(s) for s in (32, 31)},
           "jamba": _jamba_time_shards()}
    _layout_run((2, 1), 2, save=ckpt_dir)
    out["next"] = _layout_run((2, 1), 1, restore=ckpt_dir)["rows"]
    out["production"] = {mesh: _production_refusal(mesh)
                         for mesh in ("production", "production-multipod")}
    return out


def _production_refusal(mesh):
    """(whether ``make_production_mesh`` built a DeviceMesh here, the
    launcher's error) for ``--mesh mesh`` on this world."""
    import argparse

    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_production_mesh

    built = make_production_mesh(multi_pod=mesh.endswith("multipod")).device_mesh is not None
    try:
        launch_train._mesh(argparse.Namespace(mesh=mesh, seq_shards=1),
                           torch.device("cpu"))
    except ValueError as e:
        return built, str(e)
    return built, None


def layouts_world4(rank, ckpt_dir):
    """On 4 gloo ranks: a step at (2, 2), and the checkpoint written at 2
    ranks restored at (2, 2) (the batch split in two, as at 2 ranks, the
    parameters in four blocks) and stepped once."""
    _one_thread()
    return {"dp_tp": _layout_run((2, 2), 1),
            "next": _layout_run((2, 2), 1, restore=ckpt_dir)["rows"]}


# ---------------------------------------------------------------------------
# the dry-run's collectives against a DTensor step's
# ---------------------------------------------------------------------------
def dtensor_step_collectives(rank, casts):
    """For each ``cast_params_bf16`` in ``casts``, one f32 train step of
    goom-rnn smoke (``remat="none"``, batch 4 of 32 tokens, each rank its
    slice) with DTensor parameters over a (2, 2) ("data", "model") mesh:
    ``CommDebugMode``'s counts by kind, and each collective as (kind,
    result bytes), read from the functional collectives' outputs; with the
    parameter shapes and specs."""
    return [_dtensor_step_collectives(cast) for cast in casts]


def _dtensor_step_collectives(cast_params_bf16):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import engine as eng
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.sharding import distribute_model, make_rules, param_specs, use_rules
    from repro_torch.train import init_train_state, make_train_step

    _one_thread()
    kinds = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
             "all_reduce": "all-reduce"}
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            name = func._overloadpacket.__name__
            if name in kinds:
                seen.append((kinds[name], out.numel() * out.element_size()))
            return out

    mesh = _device_mesh((2, 2), ("data", "model"), "cpu")
    rules = make_rules(mesh)
    model, opt = _train_model()
    model.cfg = dataclasses.replace(model.cfg, remat="none")
    specs = param_specs(rules, model)
    shapes = {n: (tuple(p.shape), str(p.dtype)) for n, p in model.named_parameters()}
    distribute_model(model, rules)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, rules=rules, cast_params_bf16=cast_params_bf16)
    comm = CommDebugMode()
    with use_rules(rules), eng.use_backend("torch_reference"), comm, Record():
        state, metrics = step(state, _rank_batch(rules, mesh, 0))
    counts = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
    return {"counts": counts, "seen": seen, "specs": specs, "shapes": shapes,
            "n_metrics": len(metrics) - 2}
