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


#: the rules' overrides that lay the parameters out on every mesh axis but
#: split no activation across ranks (no model-axis split of heads, channels
#: or the vocabulary): the FSDP cases held to one process to the bit
FSDP_ONLY = {"act_heads": None, "act_kv_heads": None, "act_mlp": None, "act_vocab": None}


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
    """``arch``'s smoke model at f32 compute on the seed-0 weights; ``variant``
    the goom layers' ``scan_variant``, or RWKV6's ``scan_impl``."""
    from repro_torch import DecoderLM, get_config
    from repro_torch.configs.base import transform_blocks

    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=torch.float32)
    if variant is not None and arch.startswith("rwkv6"):
        cfg = transform_blocks(cfg, lambda b: dataclasses.replace(
            b, rwkv=dataclasses.replace(b.rwkv, scan_impl=variant)))
    elif variant is not None:
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
    rules = make_rules(mesh, overrides=dict(FSDP_ONLY, **({"scan_seq": "model"}
                                                          if seq_shards else {})))
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


def layouts_ranks(tmp_path_factory):
    """``layouts_world2`` on 2 ranks and ``layouts_world4`` on 4, both
    writing and reading one checkpoint directory: {"two": [...], "four":
    [...], "ckpt": dir}.  Spawned once a test run: the first test module to
    ask spawns them under a file lock and leaves the results beside it
    (the run's temporary root, which pytest-xdist's workers share); the
    others read them."""
    import fcntl
    import os
    import pickle

    from repro_torch.launch.mesh import spawn_ranks

    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    done = root / "layouts_ranks.pkl"
    with open(root / "layouts_ranks.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if done.exists():
            with open(done, "rb") as f:
                return pickle.load(f)
        ckpt = str(tmp_path_factory.mktemp("ckpt"))
        out = {"two": spawn_ranks(layouts_world2, 2, ckpt, timeout=300),
               "four": spawn_ranks(layouts_world4, 4, ckpt, timeout=300), "ckpt": ckpt}
        with open(done, "wb") as f:
            pickle.dump(out, f)
        return out


def layouts_world2(rank, ckpt_dir):
    """On 2 gloo ranks: a step at (2, 1) (FSDP: batch and "embed" over
    data) and at (1, 2) (the model axis's splits, the batch whole), a
    ``--seq-shards 2`` step at (1, 2) and the time shards of one layer at
    S = 32 and 31; then 2 steps at (2, 1) saved to ``ckpt_dir`` and the
    third step's metrics (the next loss a restore must give); and the
    per-period gather's cases (``fsdp_world``)."""
    _one_thread()
    out = {"per_period": fsdp_world((2, 1), (1, 2)),
           "fsdp": _layout_run((2, 1), 1), "tp": _layout_run((1, 2), 1),
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
    return {"per_period": fsdp_world((2, 2)), "dp_tp": _layout_run((2, 2), 1),
            "next": _layout_run((2, 2), 1, restore=ckpt_dir)["rows"]}


# ---------------------------------------------------------------------------
# the per-period gather (sharding/gather.py): steps, gathered bytes, peaks
# ---------------------------------------------------------------------------
FSDP_ARCHS = ("goom-rnn-124m", "mixtral-8x7b")


def _fsdp_model(arch, **kw):
    from repro_torch import DecoderLM, get_config

    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=torch.float32, **kw)
    return DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def _fsdp_step(shape, arch, steps=1, int8=False):
    """``steps`` f32 steps of ``arch``'s smoke config laid out over a
    ``shape`` mesh, each rank on its batch slice, and (rank 0) the same
    from one process on the same weights with one microbatch a data rank
    (each rank's slice, as the data ranks split the batch): each step's
    metrics, the parameters and moments after the last as the port's
    gather gives them (``state_tree``) and as DTensor's ``full_tensor``
    does, and the one process's parameters."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.sharding import distribute_model, make_rules, use_rules
    from repro_torch.train import AdamW, cosine_schedule, init_train_state, make_train_step
    from repro_torch.train.data import to_device
    from repro_torch.train.train_loop import _whole

    mesh = _device_mesh(shape, ("data", "model"), "cpu")
    rules = make_rules(mesh, FSDP_ONLY)
    comp = "int8" if int8 else None
    out = {}
    model = _fsdp_model(arch)
    distribute_model(model, rules)
    opt = AdamW(cosine_schedule(3e-3, 1, 4))
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, rules=rules, grad_compression=comp)
    rows = []
    with use_rules(rules), engine.use_backend("torch_reference"):
        for i in range(steps):
            state, m = step(state, _rank_batch(rules, mesh, i))
            rows.append({k: float(v) for k, v in m.items()})
    out["rows"] = rows
    ours = {k: {n: v.detach().numpy() for n, v in _whole(tree).items()}
            for k, tree in (("params", state.params), ("mu", state.opt_state["mu"]))}
    theirs = {k: {n: v.full_tensor().detach().numpy() for n, v in tree.items()}
              for k, tree in (("params", state.params), ("mu", state.opt_state["mu"]))}
    out["gathers_agree"] = all(np.array_equal(ours[k][n], theirs[k][n])
                               for k in ours for n in ours[k])
    if dist.get_rank() == 0:
        one = _fsdp_model(arch)
        opt1 = AdamW(cosine_schedule(3e-3, 1, 4))
        st = init_train_state(one, opt1)
        step1 = make_train_step(one, opt1, microbatches=shape[0], grad_compression=comp)
        ref = []
        with engine.use_backend("torch_reference"):
            for i in range(steps):
                st, m = step1(st, to_device(global_batch(i, shape[0]), "cpu"))
                ref.append({k: float(v) for k, v in m.items()})
        out["one"] = ref
        out["params"] = ours["params"]
        out["one_params"] = {n: p.detach().numpy() for n, p in one.named_parameters()}
    return out


def _gathered_peak(remat):
    """goom-rnn smoke's f32 step at (2, 1) under ``remat``: the most
    gathered parameter bytes alive at once on this rank (the gather's own
    count), the largest period's and the outside parameters' bytes, and the
    whole model's."""
    from repro_torch.launch.dryrun import gathered_bytes
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.sharding import distribute_model, make_rules, use_rules
    from repro_torch.train import AdamW, cosine_schedule, init_train_state, make_train_step

    mesh = _device_mesh((2, 1), ("data", "model"), "cpu")
    rules = make_rules(mesh)
    model = _fsdp_model("goom-rnn-124m", remat=remat)
    distribute_model(model, rules)
    opt = AdamW(cosine_schedule(3e-3, 1, 4))
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, rules=rules)
    gather = step.param_gather
    with use_rules(rules), engine.use_backend("torch_reference"):
        step(state, _rank_batch(rules, mesh, 0))
    period = max(sum(p.numel() * 4 for i in range(lo, hi) for p in model.layers[i].parameters())
                 for lo, hi in model._periods)
    whole = sum(p.numel() * 4 for p in model.parameters())
    return {"peak": gather.peak_bytes, "live_after": gather.live_bytes,
            "bound": gathered_bytes(model), "period": period, "whole": whole}


def _measured_peak():
    """goom-rnn smoke's first f32 step at (2, 1) from a fresh state, this
    rank's peak bytes by the dry-run's own tracker (``cost.measure`` on the
    real tensors: parameters' blocks, moments, gathers, activations)."""
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.sharding import distribute_model, make_rules, use_rules
    from repro_torch.train import AdamW, cosine_schedule, init_train_state, make_train_step

    mesh = _device_mesh((2, 1), ("data", "model"), "cpu")
    rules = make_rules(mesh)
    model = _fsdp_model("goom-rnn-124m")
    distribute_model(model, rules)
    opt = AdamW(cosine_schedule(3e-3, 1, 4))
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, rules=rules)
    batch = _rank_batch(rules, mesh, 0)
    moments = [v for k, tree in state.opt_state.items() if k != "step" for v in tree.values()]
    with use_rules(rules), engine.use_backend("torch_reference"):
        _, c = cost.measure(lambda: step(state, batch), modules=[model], state=moments)
    return c.memory


def _prefill_gap(shape, arch):
    """``make_prefill_step`` (fresh caches, 2 prompts of 12 tokens) of
    ``arch``'s smoke model laid out over a ``shape`` mesh against the plain
    model on the same weights: the largest difference of the last logits
    and of any cache leaf, and the laid-out parameters' type."""
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.serve.steps import make_prefill_step
    from repro_torch.sharding import distribute_model, make_rules

    mesh = _device_mesh(shape, ("data", "model"), "cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (2, 12)))
    out = []
    for laid in (False, True):
        # no parameter requires grad: CPU matmul's path (and so its last
        # bits) depends on whether an operand does, gathered or not
        model = _fsdp_model(arch).requires_grad_(False)
        if laid:
            distribute_model(model, make_rules(mesh))
        step = make_prefill_step(model, backend="torch_reference", fresh_caches=True)
        out.append(step(tokens, model.init_caches(2, 16)))
    (l0, c0), (l1, c1) = out
    leaves = [(a, b) for x, y in zip(c0, c1) for k in x for a, b in [(x[k], y[k])]]
    return {"logits": float((l1 - l0).abs().max()), "caches": max(
        float((b.float() - a.float()).abs().max()) for a, b in leaves),
        "n_leaves": len(leaves), "laid": str(type(next(model.parameters())).__name__)}


def _nested_split():
    """A (8, 3) parameter split on dim 0 over both dims of a (2, 2) ("pod",
    "data") mesh (a multi-pod "embed"): whether the port's gather gives it
    whole, and its gradient block when every rank's loss is (rank + 1)
    times the sum of the whole (both dims batch axes: the sum of all four,
    10 everywhere)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.sharding.gather import ParamGather, full_tensor

    mesh = _device_mesh((2, 2), ("pod", "data"), "cpu").device_mesh
    x = torch.arange(24.0).reshape(8, 3)
    p = torch.nn.Parameter(distribute_tensor(x, mesh, [Shard(0), Shard(0)]))
    whole = ParamGather((0, 1))("w", p)
    (g,) = torch.autograd.grad((whole * (dist.get_rank() + 1)).sum(), [p])
    return {"whole": bool(torch.equal(whole.detach(), x)),
            "full_tensor": bool(torch.equal(full_tensor(p.detach()), x)),
            "grad": g.to_local().tolist(), "block": tuple(p.to_local().shape)}


def fsdp_world(*shapes):
    """The per-period gather's cases on this world: for each mesh ``shape``
    a goom-rnn and a Mixtral (MoE) smoke step against one process; on 2
    ranks also 2 int8 steps at (1, 2), the gathered bytes under ``full``
    and ``dots``, the measured peak at (2, 1) and laid-out prefills; on 4
    a dim split over two mesh dims (``_nested_split``)."""
    out = {"steps": {(shape, arch): _fsdp_step(shape, arch)
                     for shape in shapes for arch in FSDP_ARCHS}}
    if shapes == ((2, 2),):
        out["nested"] = _nested_split()
    if shapes == ((2, 1), (1, 2)):
        out["int8"] = _fsdp_step((1, 2), "goom-rnn-124m", steps=2, int8=True)
        out["gathered"] = {r: _gathered_peak(r) for r in ("full", "dots")}
        out["peak"] = _measured_peak()
        out["prefill"] = {(shape, arch): _prefill_gap(shape, arch)
                          for shape in shapes for arch in FSDP_ARCHS}
    return out


# ---------------------------------------------------------------------------
# the dry-run's collectives against a DTensor step's
# ---------------------------------------------------------------------------
def dtensor_step_collectives(rank, cases):
    """For each (``cast_params_bf16``, remat) in ``cases``, one f32 train
    step of goom-rnn smoke (batch 4 of 32 tokens, each rank its slice)
    with DTensor parameters over a (2, 2) ("data", "model") mesh:
    ``CommDebugMode``'s counts by kind, and each collective as (kind,
    result bytes), read from the collectives' results (the functional
    ones' outputs, c10d's output arguments); with the parameter shapes and
    specs."""
    return [_dtensor_step_collectives(*case) for case in cases]


def _dtensor_step_collectives(cast_params_bf16, remat):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import engine as eng
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.sharding import distribute_model, make_rules, param_specs, use_rules
    from repro_torch.sharding import tensor_parallel
    from repro_torch.train import init_train_state, make_train_step

    _one_thread()
    # functional collectives (DTensor's: the metrics, the clip) and c10d's
    # (the parameters' gathers and their gradients', sharding/gather.py):
    # each kind with where its result is
    kinds = {"all_gather_into_tensor": ("all-gather", lambda a, out: out),
             "reduce_scatter_tensor": ("reduce-scatter", lambda a, out: out),
             "all_reduce": ("all-reduce", lambda a, out: out),
             "_allgather_base_": ("all-gather", lambda a, out: a[0]),
             "_reduce_scatter_base_": ("reduce-scatter", lambda a, out: a[0]),
             "allreduce_": ("all-reduce", lambda a, out: a[0][0])}
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            name = func._overloadpacket.__name__
            if name in kinds:
                kind, result = kinds[name]
                t = result(args, out)
                seen.append((kind, t.numel() * t.element_size()))
            return out

    mesh = _device_mesh((2, 2), ("data", "model"), "cpu")
    rules = make_rules(mesh)
    model, opt = _train_model()
    model.cfg = dataclasses.replace(model.cfg, remat=remat)
    specs = param_specs(rules, model)
    shapes = {n: (tuple(p.shape), str(p.dtype)) for n, p in model.named_parameters()}
    distribute_model(model, rules)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, rules=rules, cast_params_bf16=cast_params_bf16)
    comm = CommDebugMode()
    split_ops = []
    with use_rules(rules), eng.use_backend("torch_reference"), comm, Record(), \
            tensor_parallel.listening(lambda kind, n, size: split_ops.append((kind, n, size))):
        state, metrics = step(state, _rank_batch(rules, mesh, 0))
    names = {"_allgather_base_": "all_gather_into_tensor", "allreduce_": "all_reduce",
             "_reduce_scatter_base_": "reduce_scatter_tensor"}
    counts = {}
    for k, v in comm.get_comm_counts().items():
        k = str(k).split(".")[-1]
        counts[names.get(k, k)] = counts.get(names.get(k, k), 0) + v
    return {"counts": counts, "seen": seen, "specs": specs, "shapes": shapes,
            "n_metrics": len(metrics) - 2, "split_ops": split_ops,
            "roles": model.split_roles(rules)}


# ---------------------------------------------------------------------------
# the model axis: heads, channels and the vocabulary split across ranks
# ---------------------------------------------------------------------------
#: (arch, goom scan variant) of the model-axis train cases
MODEL_AXIS_TRAIN = (("goom-rnn-124m", "shared_a"), ("goom-rnn-124m", "generic"),
                    ("olmo-1b", None), ("gemma3-1b", None), ("jamba-v0.1", None))
#: the prefill cases: olmo's 4 KV heads split, gemma3's one replicated
MODEL_AXIS_PREFILL = ("olmo-1b", "gemma3-1b")
#: the prefill's prompts (rows, tokens) and cache length
MODEL_AXIS_PROMPT = (2, 12, 16)


def model_axis_model(arch, variant=None, f64=False):
    """``arch``'s smoke model (``variant`` for goom-rnn) at f32 compute on
    the seed-0 weights; with ``f64`` the same weights cast to float64 and
    float64 compute (the one-process yardstick)."""
    model = _smoke_model(arch, variant)
    if f64:
        cfg = model.cfg
        model = model.double()
        model.cfg = dataclasses.replace(cfg, compute_dtype=torch.float64,
                                        param_dtype=torch.float64)
    return model


def model_axis_prompt():
    rows, n, _ = MODEL_AXIS_PROMPT
    return torch.as_tensor(np.random.default_rng(3).integers(0, 256, (rows, n)))


class _Recording:
    """A ``ParamGather`` that keeps the shape of what it hands each name."""

    def __init__(self, gather):
        self.gather, self.shapes = gather, {}

    def __call__(self, name, p, role=None):
        out = self.gather(name, p, role)
        self.shapes[name] = tuple(out.shape)
        return out


def _model_axis_grads(rules, mesh, arch, variant, laid):
    """The first-step loss, the clip's global norm and the whole gradients
    of ``arch`` on this rank's batch slice, its parameters laid out
    (``laid``) or plain, under ``rules``: each rank's loss and gradients
    are averaged over the batch ranks, as the train step does
    (``make_train_step``); the shape each parameter reached its module in."""
    import torch.distributed as dist

    from repro_torch.sharding import distribute_model, use_rules
    from repro_torch.sharding.gather import ParamGather, batch_mesh_dims, full_tensor
    from repro_torch.train.optimizer import global_norm

    model = model_axis_model(arch, variant)
    if laid:
        distribute_model(model, rules)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    b = _rank_batch(rules, mesh, 0)
    dims = batch_mesh_dims(mesh.axis_names, rules)
    n_batch = int(np.prod([mesh.shape[mesh.axis_names[i]] for i in dims]))
    gather = _Recording(ParamGather(dims))
    with use_rules(rules), engine.use_backend("torch_reference"):
        loss, _ = model.loss(b["tokens"], b["labels"], param_gather=gather)
        grads = torch.autograd.grad(loss, params)
    if not laid and n_batch > 1:   # plain parameters: the data ranks' mean by hand
        for g in grads:
            dist.all_reduce(g, group=mesh.get_group("data"))
    norm = float(global_norm(list(grads))) / n_batch    # the clip's, over the layout
    grads = [full_tensor(g) / n_batch for g in grads]
    loss = loss.detach().clone()
    if n_batch > 1:
        dist.all_reduce(loss, group=mesh.get_group("data"))
    return {"loss": float(loss) / n_batch, "norm": norm,
            "grads": {n: g.detach().numpy() for n, g in zip(names, grads)},
            "gathered": gather.shapes, "roles": model.split_roles(rules)}


def _model_axis_prefill(rules, arch):
    """A fresh-cache prefill of ``MODEL_AXIS_PROMPT`` with the smoke model
    laid out under ``rules``: the last logits and every cache leaf."""
    from repro_torch.serve.steps import make_prefill_step
    from repro_torch.sharding import distribute_model, use_rules

    model = model_axis_model(arch).requires_grad_(False)
    distribute_model(model, rules)
    with use_rules(rules):
        caches = model.init_caches(MODEL_AXIS_PROMPT[0], MODEL_AXIS_PROMPT[2])
    step = make_prefill_step(model, backend="torch_reference", fresh_caches=True)
    with use_rules(rules):
        logits, caches = step(model_axis_prompt(), caches)
    return {"logits": logits.numpy(),
            "caches": [{k: v.float().numpy() for k, v in layer.items()} for layer in caches]}


def model_axis_world(rank, shape):
    """The model-axis cases on a ``shape`` ("data", "model") mesh under the
    default rules: each train case's loss and gradients laid out, goom-rnn's
    also with plain parameters (the launcher's branch for gloo ranks that
    share a card), and on (1, 2) each prefill case."""
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.sharding import make_rules

    _one_thread()
    mesh = _device_mesh(shape, ("data", "model"), "cpu")
    rules = make_rules(mesh)
    out = {"train": {case: _model_axis_grads(rules, mesh, *case, laid=True)
                     for case in MODEL_AXIS_TRAIN},
           "plain": _model_axis_grads(rules, mesh, "goom-rnn-124m", "shared_a", laid=False)}
    if shape == (1, 2):
        out["prefill"] = {arch: _model_axis_prefill(rules, arch) for arch in MODEL_AXIS_PREFILL}
        out["vocab"] = _vocab_case(rules)
        out["other_thread"] = _backward_on_another_thread(rules, mesh)
    return out


def _backward_on_another_thread(rules, mesh):
    """goom-rnn smoke laid out under ``rules`` (remat ``full``): its loss made
    on this thread, its gradients once here and once on a thread that holds
    no rules, as autograd's device thread runs a CUDA tensor's backward and
    the periods' recomputation with it: the largest difference."""
    import threading

    from repro_torch.sharding import distribute_model, use_rules
    from repro_torch.sharding.gather import ParamGather, full_tensor

    grads = []
    for other in (False, True):
        model = model_axis_model("goom-rnn-124m", "shared_a")
        assert model.cfg.remat == "full"
        distribute_model(model, rules)
        params = list(model.parameters())
        b = _rank_batch(rules, mesh, 0)
        with use_rules(rules), engine.use_backend("torch_reference"):
            loss, _ = model.loss(b["tokens"], b["labels"], param_gather=ParamGather((0,)))
            if not other:
                got = torch.autograd.grad(loss, params)
        if other:
            box = {}

            def run():
                with engine.use_backend("torch_reference"):
                    box["g"] = torch.autograd.grad(loss, params)

            t = threading.Thread(target=run)
            t.start()
            t.join()
            got = box["g"]
        grads.append([full_tensor(g) for g in got])
    return max(float((a - b).abs().max()) for a, b in zip(*grads))


#: the vocabulary-split case: a vocabulary that two ranks split unevenly
VOCAB_CASE = dict(vocab=11, rows=3, tokens=5, d=4)


def vocab_case_inputs():
    """Logits (rows, tokens, vocab), labels with a masked -1, tokens and an
    embedding table, from a seed."""
    c = VOCAB_CASE
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((c["rows"], c["tokens"], c["vocab"])).astype(np.float32) * 3
    labels = rng.integers(0, c["vocab"], (c["rows"], c["tokens"]))
    labels[0, 1] = -1
    table = rng.standard_normal((c["vocab"], c["d"])).astype(np.float32)
    return logits, labels, labels.clip(0), table


def _vocab_case(rules):
    """This rank's split NLL of ``vocab_case_inputs`` (its block of the
    logits) with the gradient of its block, and its split embedding lookup
    with the gradient of the whole table (a plain parameter read split)."""
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.sharding import use_rules

    logits, labels, tokens, table = vocab_case_inputs()
    v = VOCAB_CASE["vocab"]
    with use_rules(rules):
        sp = tp.split_of("act_vocab", v)
        lo, k = sp.block(v)
        block = torch.tensor(logits[..., lo:lo + k], requires_grad=True)
        nll = tp.split_nll(block, torch.tensor(labels), sp, v)
        (g_block,) = torch.autograd.grad(nll, [block])
        w = torch.tensor(table, requires_grad=True)
        x = tp.embedding(torch.tensor(tokens), tp.sum_grad(w, sp), sp, v)
        (g_w,) = torch.autograd.grad((x * torch.arange(x.numel()).view_as(x)).sum(), [w])
    return {"block": (lo, k), "nll": float(nll), "grad": g_block.numpy(),
            "embed": x.detach().numpy(), "embed_grad": g_w.numpy()}


# ---------------------------------------------------------------------------
# the rest of the model axis: RWKV6, the MoE experts, sequence-split caches
# ---------------------------------------------------------------------------
#: (arch, variant) of the train cases: RWKV6 in both scans (``scan_impl``),
#: mixtral's capacity-routed MoE, Jamba's Mamba and MoE both split
MODEL_AXIS_REST_TRAIN = (("rwkv6-7b", "float"), ("rwkv6-7b", "goom"), ("mixtral-8x7b", None),
                         ("jamba-v0.1", None))
#: gemma3-1b smoke under ``cache_seq="model"``: (prompt tokens, cache length);
#: 14 of 24: the prompt fills rows on both ranks, and decoding from position
#: 14 crosses the 16-row rolling buffer's wrap; 20 of 16: the prompt outgrows
#: both caches (the global keeps its last 16, the rolling buffer rolls)
SEQ_SPLIT_CASES = ((14, 24), (20, 16))
SEQ_SPLIT_DECODES = 3


def seq_split_prompt(n):
    return torch.as_tensor(np.random.default_rng(4).integers(0, 256, (2, n)))


def seq_split_run(model, n, length, rules=None, f32_kv=False):
    """A fresh prefill of ``seq_split_prompt(n)`` into caches of ``length``
    and ``SEQ_SPLIT_DECODES`` greedy decode steps, under ``rules``: each
    step's logits (whole), its tokens, the caches after the prefill and at
    the end.  The caches' K/V are bf16, or with ``f32_kv`` f32: a decode
    step writes K/V computed a rounding apart on the ranks and on one
    process, which bf16 can round a step apart (and the next layers' K/V
    then several steps near zero), so only f32 caches keep the decode an
    f32 rounding apart."""
    from repro_torch.serve.steps import make_prefill_step
    from repro_torch.sharding import use_rules

    prompt = seq_split_prompt(n)
    rows = prompt.shape[0]
    prefill = make_prefill_step(model, backend="torch_reference", fresh_caches=True)
    with use_rules(rules):
        caches = model.init_caches(rows, length)
        if f32_kv:
            caches = [{k: v.float() if k in ("k", "v") else v for k, v in c.items()}
                      for c in caches]
        logits, caches = prefill(prompt, caches)
        first = [{k: v.float().numpy() for k, v in layer.items()} for layer in caches]
        steps, tokens = [logits[:, -1].numpy()], []
        index = torch.full((rows,), n, dtype=torch.long)
        for _ in range(SEQ_SPLIT_DECODES):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            tokens.append(tok[:, 0].numpy())
            with engine.use_backend("torch_reference"):
                logits, caches = model.decode_step(tok, caches, index)
            steps.append(logits[:, -1].numpy())
            index = index + 1
    return {"logits": np.stack(steps), "tokens": np.stack(tokens), "prefill_caches": first,
            "caches": [{k: v.float().numpy() for k, v in layer.items()} for layer in caches]}


def _rest_prefill_moe(rules):
    """mixtral smoke's fresh prefill (dropless routing) laid out under
    ``rules``: the last logits."""
    from repro_torch.serve.steps import make_prefill_step
    from repro_torch.sharding import distribute_model, use_rules

    model = model_axis_model("mixtral-8x7b").requires_grad_(False)
    distribute_model(model, rules)
    step = make_prefill_step(model, backend="torch_reference", fresh_caches=True)
    with use_rules(rules):
        logits, _ = step(model_axis_prompt(), model.init_caches(MODEL_AXIS_PROMPT[0],
                                                                 MODEL_AXIS_PROMPT[2]))
    return logits.numpy()


def _seq_split_cases(mesh):
    """gemma3 smoke laid out under the default rules with ``cache_seq`` on
    "model": ``seq_split_run`` of each ``SEQ_SPLIT_CASES``, bf16 and f32 K/V."""
    from repro_torch.sharding import distribute_model, make_rules

    rules = make_rules(mesh, {"cache_seq": "model"})
    model = model_axis_model("gemma3-1b").requires_grad_(False)
    distribute_model(model, rules)
    return {(case, f32): seq_split_run(model, *case, rules=rules, f32_kv=f32)
            for case in SEQ_SPLIT_CASES for f32 in (False, True)}


def _lmme_shapes(rules, mesh):
    """The operand shapes of each LMME call of RWKV6 smoke's (``goom``) split
    loss on this rank."""
    calls = []
    saved = engine.lmme

    def recording(a, b, *args, **kw):
        calls.append((tuple(a.log_abs.shape), tuple(b.log_abs.shape)))
        return saved(a, b, *args, **kw)

    engine.lmme = recording
    try:
        _model_axis_grads(rules, mesh, "rwkv6-7b", "goom", laid=True)
    finally:
        engine.lmme = saved
    return sorted(set(calls))


def _entered_x(cls, module, width):
    """``cls.forward`` mutated as if its whole input x entered the split at
    the top (every ``enter`` inside the module made the identity): the
    trap an ``enter`` placed at the top of a block falls into."""
    import contextlib

    from repro_torch.sharding import tensor_parallel as tp

    @contextlib.contextmanager
    def mutated():
        forward, inner = cls.forward, module.enter

        def wrapped(self, x, **kw):
            x = tp.enter(x, tp.split_of("act_mlp", width(self)))
            module.enter = lambda t, sp: t
            try:
                return forward(self, x, **kw)
            finally:
                module.enter = inner

        cls.forward = wrapped
        try:
            yield
        finally:
            cls.forward = forward

    return mutated()


def _mutations(rules, mesh):
    """The split step with x entering at the top of the channel mix (RWKV6,
    ``float``) and of the MoE (mixtral): loss and gradients as
    ``_model_axis_grads``."""
    from repro_torch.models import mlp, ssm

    out = {}
    with _entered_x(ssm.Rwkv6ChannelMix, ssm, lambda m: m.d_ff):
        out[("rwkv6-7b", "float")] = _model_axis_grads(rules, mesh, "rwkv6-7b", "float", True)
    with _entered_x(mlp.Moe, mlp, lambda m: m.cfg.d_ff):
        out[("mixtral-8x7b", None)] = _model_axis_grads(rules, mesh, "mixtral-8x7b", None, True)
    return out


#: the split RMSNorm case: rows, channels, and a seed
LN_X_CASE = dict(rows=6, d=8)


def ln_x_inputs():
    rng = np.random.default_rng(6)
    c = LN_X_CASE
    return (rng.standard_normal((c["rows"], c["d"])).astype(np.float32) * 3,
            rng.standard_normal(c["d"]).astype(np.float32),
            rng.standard_normal((c["rows"], c["d"])).astype(np.float32))


def _ln_x_case(rules):
    """RWKV6's ``ln_x`` on this rank's block of ``ln_x_inputs``' channels:
    the block's output and the gradient of its block of y (the loss
    sum(out · w) over every rank's block)."""
    from repro_torch.models.ssm import _split_rmsnorm
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.sharding import use_rules

    y, scale, w = ln_x_inputs()
    d = LN_X_CASE["d"]
    with use_rules(rules):
        sp = tp.split_of("act_heads", d)
        lo, k = sp.block(d)
        yb = torch.tensor(y[:, lo:lo + k], requires_grad=True)
        out = _split_rmsnorm(yb, torch.tensor(scale[lo:lo + k]), d, sp)
        (g,) = torch.autograd.grad((out * torch.tensor(w[:, lo:lo + k])).sum(), [yb])
    return {"block": (lo, k), "out": out.detach().numpy(), "grad": g.numpy()}


def model_axis_rest_world(rank, shape):
    """The rest of the model axis on a ``shape`` ("data", "model") mesh under
    the default rules: each ``MODEL_AXIS_REST_TRAIN`` case's loss and
    gradients laid out (``_model_axis_grads``); on (1, 2) also mixtral's
    dropless prefill, gemma3's sequence-split caches, RWKV6's LMME shapes,
    the two ``enter`` mutations and the split ``ln_x``."""
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.sharding import make_rules

    _one_thread()
    mesh = _device_mesh(shape, ("data", "model"), "cpu")
    rules = make_rules(mesh)
    out = {"train": {case: _model_axis_grads(rules, mesh, *case, laid=True)
                     for case in MODEL_AXIS_REST_TRAIN}}
    if shape == (1, 2):
        out.update(moe_prefill=_rest_prefill_moe(rules), seq_split=_seq_split_cases(mesh),
                   lmme_shapes=_lmme_shapes(rules, mesh), mutated=_mutations(rules, mesh),
                   ln_x=_ln_x_case(rules))
    return out
