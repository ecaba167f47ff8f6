"""Dry-run of every (arch × shape × mesh) cell on fake tensors.

The port of ``repro/launch/dryrun.py``.  Where JAX lowers and compiles each
cell for 512 host devices, the port runs each cell's real step under
``FakeTensorMode`` (``launch/cost.py``): no device is needed, nothing is
allocated and no kernel is launched.  The fake tensors sit on the CPU (a
CPU-only build of torch cannot index fake CUDA tensors) and the engine runs
its ``cuda`` backend, the card's dispatch: the GOOM kernels take their card
path up to the launch (``kernels/shape_only.py``).  For each cell it records:

  * a device's FLOPs, bytes and GOOM kernel calls, traced at the device's
    slice of the batch (rows over the rules' batch axes);
  * its memory: the tracker's peak by category, and the bytes a device
    holds (below);
  * the collectives of the port's step, from the layouts (below);
  * the three roofline terms on the H100's constants (``launch/roofline.py``),
    and the host seconds the cell took.

**What a device holds follows the port as it is.**  Cells on more than
one device lay the parameters out by ``sharding.param_specs`` (JAX's
``param_shardings``) and the dry-run traces the laid-out step of one rank
itself: the process joins torch's fake process group as rank 0 of the
mesh's world (``fake_ranks``), ``sharding.distribute_model`` lays the
model out over it as the launcher does, and the production step runs
(``make_train_step``), its gathers and reductions on the port's
collectives (``sharding/gather.py``), which move nothing over the fake
group.  So the trace allocates what a rank allocates: its parameter
blocks and their moments (``launch.train.state_placements``), one
period's gathered parameters at a time (bf16 under ``cast_params_bf16``;
again in the recomputation under ``full`` and ``dots``), the embedding,
final norm and head while they are gathered, one period's whole gradients
before their reduce-scatter, and its batch slice's activations; the
update runs on the blocks.  The peak is the trace's.  The collectives'
bytes are the collective term below, not memory traffic.
``gathered_param_bytes`` is the most a rank holds gathered at once: the
largest period's parameters and those outside the periods.
Prefill and decode cells lay the parameters out the same way and gather
one period at a time without a gradient; a rank's caches come from
``init_caches`` under the cell's rules (``cache_bytes``), and the bytes
JAX's cache layout (``_CACHE_AXES``, ``cache_shardings``) would leave it
are reported beside them (``cache_shard_bytes``).  ``long_500k`` (its
cache's sequence over "data" too) is traced on one rank's rows with whole
parameters and caches.  Cells whose peak passes the card's 80 GB are
marked ``over_hbm``.

**The model axis.**  The traces run under the cell's rules, so a rank
splits what the port splits (``sharding/tensor_parallel.py``): the
attention heads, the dense MLP's channels, the goom layer's heads, Mamba's
channels, RWKV6's heads and channels, the MoE experts' channels and the
vocabulary run on the rank's block, their split weights gathered over the
batch axes only.  A serve rank's caches hold its block of the KV heads
where they divide the model axis; where they do not, JAX puts the cache's
sequence on "model" and so does the port: the rank holds its block of
each cache's rows.  So ``cache_bytes`` equals ``cache_shard_bytes``
wherever the port's layout is JAX's.  The MoE's expert dim stays whole
on every rank of "data".

**Collectives** (train cells on more than one device), as the port's step
runs them, one op per mesh dim: each parameter's gather, the last mesh dim
first, an all-gather over each mesh dim it is sharded on, once for each
microbatch (the tied embedding twice: embedding and head) and once more in
the recomputation of a period under ``full`` and ``dots``; for each
gathered gradient, over each batch dim in mesh order, a reduce-scatter
where the parameter is sharded on it, else an all-reduce; an all-reduce
of the metrics over each batch dim; one of the clip's sum of squares over each mesh dim any parameter is
sharded on; and, when ``scan_seq`` maps to a mesh axis, the recurrent
layers' time shards (an all-gather of each one's output, an all-reduce of
each gradient it reads replicated).  A split module's weight (``roles``,
``DecoderLM.split_roles``) is gathered over the batch dims only where the
layout splits the dim it reads on the model axis; one it reads whole has
its gradient summed over the model axis too.  The split modules'
activation collectives (the all-reduces where partial sums leave a split
region and gradients enter one, the goom layer's max, the split NLL's
all-gather and all-reduce) are the trace's own, summed by kind
(``cost.Cost.collectives``).  A laid-out serve step's collectives are its
parameters' gathers (as above, without gradients) and the trace's own
(among them RWKV6's ``ln_x`` sums and a sequence-split decode's combine).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out f.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --serve-cache-report --all
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch

from ..configs import ASSIGNED_ARCHS, SHAPES, ShapeCfg, get_config, input_specs, shape_applicable
from ..configs.base import transform_blocks
from ..core import engine
from ..kernels.dispatch import current_platform
from ..sharding.layout import shard_shape
from ..sharding.mesh import NamedMesh
from ..sharding.rules import AxisRules, distribute_model, make_rules, param_specs, use_rules
from . import cost
from .mesh import make_production_mesh
from .roofline import (
    HBM_BYTES,
    CollectiveOp,
    Roofline,
    collective_bytes_per_device,
    model_flops,
)

__all__ = ["SkipCell", "fake_ranks", "lower_cell", "serve_cache_report", "cache_specs",
           "gather_counts", "gathered_bytes", "train_collectives", "activation_collectives",
           "main"]

GIB = 2 ** 30


class SkipCell(Exception):
    pass


# ---------------------------------------------------------------------------
# layouts: caches, parameters, the batch
# ---------------------------------------------------------------------------
_CACHE_AXES = {
    # cache leaf name -> logical names of its trailing dims
    "k": ("batch", "cache_seq", "kv_cache_heads", None),
    "v": ("batch", "cache_seq", "kv_cache_heads", None),
    "index": ("batch",),  # per-slot (B,) position vector
    "wkv": ("batch", "act_heads", None, None),
    "x_prev": ("batch", None, "act_embed"),
    "cm_x_prev": ("batch", None, "act_embed"),
    "conv": ("batch", None, "act_mlp"),
    "ssm": ("batch", "act_mlp", None),
    "x_log": ("batch", "act_heads", None, None),
    "x_sign": ("batch", "act_heads", None, None),
}


def cache_specs(rules: AxisRules, caches) -> Dict[str, tuple]:
    """Each cache leaf's spec (``"<layer>.<leaf>"`` -> spec), JAX's
    ``cache_shardings`` over the port's per-layer caches: a leaf's logical
    names by its name, leading dims unnamed, unknown leaves replicated."""
    out = {}
    for i, layer in enumerate(caches):
        for key, leaf in layer.items():
            names = list(_CACHE_AXES.get(key, (None,) * leaf.ndim))
            names = ([None] * (leaf.ndim - len(names)) + names)[-leaf.ndim:] if leaf.ndim else []
            out[f"{i}.{key}"] = rules.spec(tuple(leaf.shape), names)
    return out


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def batch_shards(rules: AxisRules, shape: ShapeCfg) -> int:
    """The devices the global batch splits over (the rules' batch axes
    that divide it)."""
    spec = rules.spec((shape.global_batch,), ("batch",))
    axes = () if not spec or spec[0] is None else (
        (spec[0],) if isinstance(spec[0], str) else spec[0])
    return math.prod(rules.mesh.shape[a] for a in axes)


def _axes_of(spec) -> List[str]:
    out = []
    for entry in spec:
        if entry is not None:
            out.extend((entry,) if isinstance(entry, str) else entry)
    return out


def gather_counts(cfg, names, *, microbatches: int = 1) -> Dict[str, Tuple[int, int]]:
    """name -> (the parameter's gathers in a train step, the reductions of
    their gradients): one of each a microbatch, the tied embedding's twice
    (the embedding and the head), and a period's gathers once more in its
    recomputation under ``full`` and ``dots``."""
    out = {}
    for n in names:
        k = 2 if n == "embed" and cfg.tie_embeddings else 1
        again = 2 if n.startswith("layers.") and cfg.remat != "none" else 1
        out[n] = (k * again * microbatches, k * microbatches)
    return out


def train_collectives(rules: AxisRules, params: Dict[str, Tuple[tuple, torch.dtype]],
                      specs: Dict[str, tuple], *, cast_params_bf16: bool = False,
                      n_metrics: int = 3, time_shards: Optional[List[Tuple[int, list]]] = None,
                      counts: Optional[Dict[str, Tuple[int, int]]] = None,
                      roles: Optional[Dict[str, Tuple[str, Optional[int]]]] = None,
                      grads: bool = True) -> List[CollectiveOp]:
    """The collectives of one laid-out train step's parameters (module
    docstring).  ``params``: name -> (whole shape, dtype); ``counts``: name
    -> (gathers, reductions) (``gather_counts``; default one each);
    ``time_shards``: per recurrent layer, (its output's bytes, the bytes of
    each gradient it reads replicated), when ``scan_seq`` maps to a mesh
    axis; ``roles``: name -> (mesh axis, dim) of the weights split modules
    read (``DecoderLM.split_roles``).  ``grads=False``: the gathers alone
    (a serve step's)."""
    size = rules.mesh.shape
    names = list(rules.mesh.axis_names)
    batch = set(a for a in rules.mesh_axes_for("batch") if a in size)
    ops: List[CollectiveOp] = []
    sharded_dims = set()
    for name, (shape, dtype) in params.items():
        if cast_params_bf16 and dtype == torch.float32:
            dtype = torch.bfloat16
        whole = _bytes(shape, dtype)
        spec = specs[name]
        axes = sorted(_axes_of(spec), key=names.index)   # mesh order
        sharded_dims.update(axes)
        axes = [a for a in axes if size[a] > 1]   # a 1-sized dim moves nothing
        kept, summed = _split_role(spec, (roles or {}).get(name))
        gathers, reductions = (counts or {}).get(name, (1, 1))
        part = whole // math.prod(size[a] for a in axes)
        for a in reversed(axes):           # gathered the last mesh dim first
            if a != kept:
                part *= size[a]
                ops.extend([CollectiveOp("all-gather", part, size[a])] * gathers)
        local = part                       # the gradient as the step makes it
        for a in (a for a in names if size[a] > 1 and a != kept and grads):
            if (a in batch or a == summed) and a in axes:
                local //= size[a]
                ops.extend([CollectiveOp("reduce-scatter", local, size[a])] * reductions)
            elif a in batch or a == summed:
                ops.extend([CollectiveOp("all-reduce", local, size[a])] * reductions)
            elif a in axes:
                local //= size[a]          # this rank's slice, no collective
    if not grads:
        return ops
    ops.extend(CollectiveOp("all-reduce", 4 * n_metrics, size[a]) for a in names
               if a in batch)
    ops.extend(CollectiveOp("all-reduce", 4, size[a]) for a in names if a in sharded_dims)
    seq = rules.mesh_axes_for("scan_seq")
    if time_shards and seq and size[seq[0]] > 1:
        for out_bytes, replicated in time_shards:
            ops.append(CollectiveOp("all-gather", out_bytes, size[seq[0]]))
            ops.extend(CollectiveOp("all-reduce", b, size[seq[0]]) for b in replicated)
    return ops


def _split_role(spec, role) -> Tuple[Optional[str], Optional[str]]:
    """(the mesh axis whose block a split module reads as the layout holds
    it, the mesh axis its gradient is summed over instead) for a parameter
    of ``spec`` read with ``role`` (``sharding/gather.py``); (None, None)
    for a parameter no split module reads."""
    if role is None:
        return None, None
    axis, dim = role
    entry = spec[dim] if dim is not None and dim < len(spec) else None
    return (axis, None) if entry == axis else (None, axis)


def activation_collectives(c: cost.Cost) -> List[CollectiveOp]:
    """The split modules' collectives of a traced step, one op a kind and
    group size carrying their summed bytes (the roofline's term is linear in
    them)."""
    out = []
    for key, nbytes in sorted(c.collectives.items()):
        kind, size = key.rsplit("/", 1)
        out.append(CollectiveOp(kind, int(round(nbytes)), int(size)))
    return out


def _time_shard_bytes(cfg, rows: int, seq_len: int, cast: bool) -> List[Tuple[int, list]]:
    """Per recurrent layer: the bytes of the output its time shards gather,
    and of the gradients of what it reads replicated (goom layer: A, B, C,
    D; Mamba: A)."""
    out = []
    pbytes = 2 if cast or cfg.param_dtype == torch.bfloat16 else 4
    cd = torch.empty((), dtype=cfg.compute_dtype).element_size()
    for blk in cfg.layer_list:
        if blk.mixer == "goom_ssm":
            g = blk.goom
            rep = [pbytes * g.n_heads * g.head_dim * g.head_dim] * 2 \
                + [pbytes * g.n_heads * g.head_dim * 2 * g.head_dim] * 2
            out.append((cd * rows * seq_len * g.d_model, rep))
        elif blk.mixer == "mamba" and blk.mamba.scan_impl == "goom":
            m = blk.mamba
            out.append((4 * rows * seq_len * m.d_inner, [4 * m.d_inner * m.d_state]))
    return out


def _pick_microbatches(cfg, shape: ShapeCfg, mesh) -> int:
    """Gradient accumulation so the per-device residual-stream stack
    (n_layers × B_local × S × d_model × 2 bytes, saved once per layer under
    full remat) stays under ~2 GiB of HBM (JAX's heuristic)."""
    data_shards = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    b_local = max(1, shape.global_batch // data_shards)
    stack = cfg.n_layers * b_local * shape.seq_len * cfg.d_model * 2
    # hybrid (mamba state expansion) carries heavier per-layer transients
    target = (1 if cfg.family == "hybrid" else 2) * 2**30
    mb = 1
    while stack / mb > target and mb < b_local:
        mb *= 2
    return mb


# ---------------------------------------------------------------------------
# the steps on fake tensors
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_ranks(mesh) -> Iterator[NamedMesh]:
    """``mesh``'s shape over torch's fake process group, this process its
    rank 0: a ``NamedMesh`` whose DTensors hold rank 0's blocks and whose
    collectives move nothing (the trace's tensors are fake).  The process
    must hold no process group of its own; the fake one ends with the
    block."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry-run of several devices joins a fake process group; "
                           "this process already has one")
    if current_platform() == "cuda":
        # the group's collectives set up the card's state on first use, which
        # a checkpointed period's forward refuses: set it up first
        torch.cuda.init()
    names = tuple(mesh.axis_names)
    sizes = tuple(int(mesh.shape[a]) for a in names)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(sizes))
    try:
        yield NamedMesh(sizes, names, init_device_mesh("cpu", sizes, mesh_dim_names=names))
    finally:
        dist.destroy_process_group()


def _length_fit(cfg) -> Optional[Tuple[int, int]]:
    """(base, step) of the lengths a long sequence's cost is fitted from
    (``cost.lengths``), or None to trace it at its length: the models with
    chunked recurrent layers (Mamba, RWKV6, the goom layer), whose full
    traces would take hours of host time.  ``step`` is the least common
    multiple of their chunks and of the flash-attention tiles (``block_q``,
    ``block_kv``: at a multiple of both nothing is padded and a layer runs
    S / block_kv key blocks), ``base`` the least multiple of it that is no
    shorter than any attention window (so the window's code path is the
    one traced)."""
    chunks = [c for blk in cfg.layer_list for c in (
        blk.mamba.chunk if blk.mamba is not None else None,
        blk.rwkv.chunk if blk.rwkv is not None and blk.mixer == "rwkv6" else None,
        blk.goom.chunk if blk.goom is not None else None) if c]
    if not chunks:
        return None
    attn = [blk.attn for blk in cfg.layer_list if blk.attn is not None]
    step = math.lcm(*chunks, *(t for a in attn for t in (a.block_q, a.block_kv)))
    window = max((a.window or 0 for a in attn), default=0)
    return max(step, -(-window // step) * step), step


def _fake_inputs(cfg, shape: ShapeCfg, rows: int) -> Dict[str, torch.Tensor]:
    """``input_specs`` at ``rows`` rows, as zero tensors."""
    specs = input_specs(cfg, dataclasses.replace(shape, global_batch=rows))
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in specs.items()}


def _rules(rules: Optional[AxisRules]):
    """The rules active for a trace (nothing without them)."""
    return contextlib.nullcontext() if rules is None else use_rules(rules)


def _model(cfg):
    from ..models.model import DecoderLM

    return DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def train_trace(cfg, shape: ShapeCfg, rows: int, microbatches: int = 1,
                cast_params_bf16: bool = False, memory: bool = True,
                rules: Optional[AxisRules] = None, backend: str = "cuda") -> cost.Cost:
    """One trace of one train step of ``cfg`` on ``rows`` rows of ``shape``
    in ``microbatches``, AdamW as JAX's dry-run, the engine on ``backend``
    (the card's dispatch by default; ``torch_reference`` allocates what
    the plain versions do, as a CPU rank); with ``rules`` over a
    ``fake_ranks`` mesh, one rank's laid-out step (module docstring).
    The cost's ``n_metrics`` is how many metrics the step reduces over the
    batch (those of the loss)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..train import AdamW, cosine_schedule, init_train_state, make_train_step

    with FakeTensorMode(), engine.use_backend(backend), _rules(rules):
        model = _model(cfg)
        if rules is not None:
            distribute_model(model, rules)
        opt = AdamW(cosine_schedule(3e-4, 100, 10_000))
        state = init_train_state(model, opt)
        step = make_train_step(model, opt, microbatches=microbatches,
                               cast_params_bf16=cast_params_bf16, rules=rules)
        batch = _fake_inputs(cfg, shape, rows)
        moments = [v for k, tree in state.opt_state.items() if k != "step"
                   for v in tree.values()]
        (_, metrics), c = cost.measure(lambda: step(state, batch), modules=[model],
                                       state=moments, memory=memory)
    c.n_metrics = len(metrics) - 2      # grad_norm and lr come after the reduction
    return c


def train_cost(cfg, shape: ShapeCfg, rows: int, *, microbatches: int = 1,
               cast_params_bf16: bool = False, rules: Optional[AxisRules] = None
               ) -> cost.Cost:
    """The cost of one train step of ``cfg`` on ``rows`` rows of ``shape``
    (``microbatches`` of ``rows / microbatches``; ``train_trace``, one
    rank's under ``rules``) from one
    and two periods of each group (``cost.periods``, which traces at most
    two microbatches at once and above two extrapolates from 2 and 3).

    Above two microbatches, for a long sequence of a model whose recurrent
    layers trace more ops the longer it is (``_length_fit``), the counts
    come from three short sequences (``cost.lengths``, no memory tracked)
    and the memory from a trace at the full length at two microbatches
    (the peak is the same at any count from two): three full-length
    traces would take hours of host time for Jamba.  At one or two
    microbatches the full-length trace is the cost, counts and memory."""
    if rows % microbatches:
        raise ValueError(f"{rows} rows do not split into {microbatches} microbatches")
    per_mb = rows // microbatches

    def at(sh, mb=microbatches, memory=True):
        return cost.periods(cfg, lambda c, k: train_trace(
            c, sh, k * per_mb, k, cast_params_bf16, memory, rules), mb)

    fit = _length_fit(cfg)
    if (microbatches <= 2 or fit is None or shape.seq_len <= fit[0] + 2 * fit[1]
            or shape.seq_len % fit[1]):
        return at(shape)
    out = cost.lengths(shape.seq_len,
                       lambda n: at(dataclasses.replace(shape, seq_len=n), memory=False),
                       base=fit[0], step=fit[1])
    full = at(shape, 2)
    out.memory, out.host_s = full.memory, out.host_s + full.host_s
    return out


def serve_trace(cfg, shape: ShapeCfg, rows: int, rules: Optional[AxisRules] = None
                ) -> cost.Cost:
    """One trace of the prefill step (``prefill`` shapes: ``rows`` prompts
    of ``seq_len`` into fresh caches, ``fresh_caches=True``: the single-shot
    prefill attends over the prompt) or of one decode step (caches of
    ``seq_len`` positions, the token at the last), the engine on its
    ``cuda`` backend; with ``rules`` over a ``fake_ranks`` mesh, on one
    rank's parameter blocks, gathered a period at a time, and its caches
    (``init_caches`` under the rules)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..serve.steps import make_decode_step, make_prefill_step

    with FakeTensorMode(), _rules(rules):
        model = _model(cfg)
        if rules is not None:
            distribute_model(model, rules)
        caches = model.init_caches(rows, shape.seq_len)
        leaves = [leaf for layer in caches for leaf in layer.values()]
        inputs = _fake_inputs(cfg, shape, rows)
        if shape.kind == "prefill":
            step = make_prefill_step(model, backend="cuda", fresh_caches=True)
            tokens = inputs.pop("tokens")
            fn = lambda: step(tokens, caches, **inputs)  # noqa: E731
        else:
            step = make_decode_step(model, backend="cuda")
            index = torch.full((rows,), shape.seq_len - 1, dtype=torch.long)
            fn = lambda: step(inputs["token"], caches, index)  # noqa: E731
        _, c = cost.measure(fn, modules=[model], state=leaves)
    return c


def serve_cost(cfg, shape: ShapeCfg, rows: int, rules: Optional[AxisRules] = None
               ) -> cost.Cost:
    """The cost of a serve step (``serve_trace``) from one and two periods
    of each group, each traced at the full length."""
    return cost.periods(cfg, lambda c, _mb: serve_trace(c, shape, rows, rules))


def gathered_bytes(model, dtype: Optional[torch.dtype] = None,
                   rules: Optional[AxisRules] = None) -> int:
    """The most parameter bytes a laid-out rank holds gathered at once: the
    largest period's and those outside the periods (f32 ones cast to
    ``dtype``); under ``rules``, a split module's weight whose block the
    layout keeps (``_split_role``) at its block."""
    roles = model.split_roles(rules) if rules is not None else {}
    specs = param_specs(rules, model) if roles else {}

    def nbytes(name, p):
        cast = dtype if dtype is not None and p.dtype == torch.float32 else p.dtype
        kept = _split_role(specs.get(name, ()), roles.get(name))[0]
        return _bytes(tuple(p.shape), cast) // (rules.mesh.shape[kept] if kept else 1)

    period = max(sum(nbytes(f"layers.{i}.{n}", p) for i in range(lo, hi)
                     for n, p in model.layers[i].named_parameters())
                 for lo, hi in model._periods)
    return period + sum(nbytes(n, p) for n, p in model.named_parameters()
                        if not n.startswith("layers."))


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------
def _cell_config(arch, perf: Dict, rules_overrides):
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if perf.get("banded"):
        def _banded(blk):
            if blk.attn is not None and blk.attn.window is not None:
                return dataclasses.replace(blk, attn=dataclasses.replace(blk.attn, use_banded=True))
            return blk

        cfg = transform_blocks(cfg, _banded)
    if perf.get("pure_fsdp"):
        # ZeRO-3: batch over both mesh axes, weights 2D-sharded and gathered
        rules_overrides = dict(rules_overrides or {}, batch=("data", "model"),
                               act_heads=None, act_kv_heads=None, act_mlp=None,
                               act_vocab=None, act_expert=None)
    if "remat" in perf:
        cfg = dataclasses.replace(cfg, remat=perf["remat"])
    if "logit_chunk" in perf:
        cfg = dataclasses.replace(cfg, logit_chunk=perf["logit_chunk"])
    return cfg, rules_overrides


_PERF_TOGGLES = {"banded", "pure_fsdp", "cast_params_bf16", "microbatches", "remat",
                 "logit_chunk"}
_DEPARTURES = {
    "seq_parallel": "the port's activations stay whole along time on every rank of the "
                    "model axis (it splits heads, channels and the vocabulary), so "
                    "sequence parallelism has nothing to shard",
    "constrain_grads": "the port's step always reduce-scatters the gradients into the "
                       "parameters' layout; there is no other behaviour to switch to",
}


def _check_perf(perf: Dict) -> None:
    for key in perf:
        if key in _DEPARTURES:
            raise ValueError(f"perf toggle {key!r} is not supported: {_DEPARTURES[key]}")
        if key not in _PERF_TOGGLES:
            raise ValueError(f"unknown perf toggle {key!r}; known: {sorted(_PERF_TOGGLES)}")


def _serve_overrides(cfg, shape: ShapeCfg, mesh, overrides: Dict) -> Dict:
    """JAX's KV-cache rules: heads over "model" when every attention layer's
    KV heads divide it, else the cache's sequence on "model"; long decode
    shards the cache's sequence over "data" too (context parallelism).
    These rules give ``cache_shard_bytes`` and the traced serve rank's
    caches: its block of each layer's KV heads where they divide the model
    axis (``act_kv_heads``), else its block of the rows (``cache_seq``;
    ``long_500k``'s, over "data" and "model", is not split: whole caches)."""
    overrides = dict(overrides)
    min_kv = min((blk.attn.n_kv_heads for blk in cfg.layer_list if blk.attn is not None),
                 default=0)
    model_size = mesh.shape.get("model", 1)
    kv_divisible = min_kv > 0 and min_kv % model_size == 0
    overrides.setdefault("kv_cache_heads", "model" if kv_divisible else None)
    if shape.kind == "long_decode":
        overrides.setdefault("cache_seq", "data" if kv_divisible else ("data", "model"))
    elif not kv_divisible:
        overrides.setdefault("cache_seq", "model")
    return overrides


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def lower_cell(arch, shape: Union[str, ShapeCfg], mesh, *, perf: Optional[Dict] = None,
               rules_overrides: Optional[Dict] = None, verbose: bool = True) -> Roofline:
    """The :class:`Roofline` of one cell; ``arch`` a registered name or an
    ``LMConfig``, ``shape`` a name in ``SHAPES`` or a ``ShapeCfg``, ``mesh``
    anything with ``shape`` and ``axis_names`` (the abstract production
    mesh).

    ``perf`` toggles JAX's perf options:
      banded=True           — banded SWA for the windowed layers
      pure_fsdp=True        — batch over both mesh axes
      cast_params_bf16=True — bf16 copies of the f32 parameters, gathered in bf16
      microbatches=N        — override the per-cell heuristic
      remat=..., logit_chunk=N

    Two of JAX's toggles are departures and raise ``ValueError``, since no
    cost of the port would move with them: ``seq_parallel`` (the port's
    activations stay whole along time on every rank of the model axis,
    which splits heads, channels and the vocabulary)
    and ``constrain_grads`` (the port's step always reduce-scatters the
    gradients into the parameters' layout).  An unknown toggle raises too.
    """
    t0 = time.perf_counter()
    perf = dict(perf or {})
    _check_perf(perf)
    cfg, rules_overrides = _cell_config(arch, perf, rules_overrides)
    arch = cfg.name
    shape_cfg = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = shape_applicable(cfg, shape_cfg)
    if not ok:
        raise SkipCell(why)
    overrides = dict(rules_overrides or {})
    if shape_cfg.kind != "train":
        overrides = _serve_overrides(cfg, shape_cfg, mesh, overrides)
    rules = make_rules(mesh, overrides)
    chips = math.prod(mesh.shape.values())
    shards = batch_shards(rules, shape_cfg)
    rows = shape_cfg.global_batch // shards
    cast = bool(perf.get("cast_params_bf16", False))

    from ..models.model import DecoderLM

    whole_model = DecoderLM(cfg, device="meta")
    params = {n: (tuple(p.shape), p.dtype) for n, p in whole_model.named_parameters()}
    param_bytes = sum(_bytes(s, d) for s, d in params.values())
    laid_out = chips > 1 and shape_cfg.kind in ("train", "prefill", "decode")
    mem: Dict[str, float] = {}
    ops: List[CollectiveOp] = []
    specs = param_specs(rules, whole_model)
    if shape_cfg.kind in ("train", "prefill", "decode"):
        dtype = torch.bfloat16 if cast and shape_cfg.kind == "train" else None
        mem.update(param_shard_bytes=float(sum(
            _bytes(shard_shape(s, specs[n], mesh.shape), d) for n, (s, d) in params.items())),
            gathered_param_bytes=float(gathered_bytes(whole_model, dtype, rules)
                                       if laid_out else 0))
    with fake_ranks(mesh) if laid_out else contextlib.nullcontext() as ranks:
        rank_rules = make_rules(ranks, overrides) if laid_out else None
        if shape_cfg.kind == "train":
            mb = perf.get("microbatches", _pick_microbatches(cfg, shape_cfg, mesh))
            mb = max(1, min(int(mb), rows))
            c = train_cost(cfg, shape_cfg, rows, microbatches=mb, cast_params_bf16=cast,
                           rules=rank_rules)
        else:
            c = serve_cost(cfg, shape_cfg, rows, rank_rules)
    if shape_cfg.kind == "train":
        if laid_out:
            ops = train_collectives(
                rules, params, specs, cast_params_bf16=cast, n_metrics=c.n_metrics,
                time_shards=_time_shard_bytes(cfg, rows, shape_cfg.seq_len, cast),
                counts=gather_counts(cfg, params, microbatches=mb),
                roles=whole_model.split_roles(rules)) + activation_collectives(c)
        mem.update(moment_shard_bytes=float(sum(
            _bytes(shard_shape(s, specs[n], mesh.shape), torch.float32)
            for n, (s, _) in params.items()) * 2), microbatches=mb)
    else:
        caches = whole_model.init_caches(shape_cfg.global_batch, shape_cfg.seq_len,
                                         device="meta")
        cspecs = cache_specs(rules, caches)
        cache_shard = sum(_bytes(shard_shape(tuple(leaf.shape), cspecs[f"{i}.{k}"],
                                             mesh.shape), leaf.dtype)
                          for i, layer in enumerate(caches) for k, leaf in layer.items())
        mem.update(cache_shard_bytes=float(cache_shard),
                   cache_bytes=float(c.memory["state"]))
        if laid_out:
            ops = train_collectives(rules, params, specs, roles=whole_model.split_roles(rules),
                                    grads=False) + activation_collectives(c)
    peak = c.memory["peak"]
    coll_bytes, coll_by_kind = collective_bytes_per_device(ops)
    mem.update({f"trace_{k}_bytes": float(v) for k, v in c.memory.items()})
    mem.update(param_bytes=float(param_bytes), above_state_bytes=float(c.above_state),
               peak_bytes=float(peak), over_hbm=bool(peak > HBM_BYTES),
               rows=rows, batch_shards=shards)
    rf = Roofline(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name(mesh), chips=chips,
        hlo_flops=c.flops * chips, hlo_bytes=c.written * chips,
        hlo_bytes_upper=c.bytes * chips,
        collective_bytes=coll_bytes, collective_by_kind=coll_by_kind,
        model_flops=model_flops(cfg, shape_cfg), memory_per_device=mem,
        f32_flops=c.f32_flops * chips,
        launches={k: int(round(v)) for k, v in c.launches.items()},
        host_s=time.perf_counter() - t0)
    if verbose:
        print(f"[{arch} × {shape_cfg.name} × {rf.mesh}] costed in {rf.host_s:.1f} s "
              f"({c.host_s:.1f} s tracing)")
        print(f"  per-device: {rows} rows, peak {peak / GIB:.2f} GiB (HBM 80 GB"
              f"{', OVER' if peak > HBM_BYTES else ''}); above the parameters and "
              f"state {c.above_state / GIB:.2f} GiB")
        print(f"  per-device FLOPs {c.flops:.3e} (f32 {c.f32_flops:.3e}), bytes "
              f"{c.written:.3e} written ({c.bytes:.3e} read and written), collective "
              f"ring-bytes {rf.collective_bytes:.3e}; GOOM launches {rf.launches}")
        print(f"  roofline: compute {rf.compute_s * 1e3:.2f} ms | memory "
              f"{rf.memory_s * 1e3:.2f} ms | collective {rf.collective_s * 1e3:.2f} ms "
              f"→ bottleneck: {rf.bottleneck}; useful/step flops "
              f"{rf.useful_fraction:.2f}; MFU {rf.mfu:.2%}")
    return rf


# ---------------------------------------------------------------------------
# serving configs from shapes alone
# ---------------------------------------------------------------------------
def serve_cache_report(archs, max_slots: int, page_len: int):
    """Bytes of the slot-managed decode state of each arch at (max_slots,
    page_len), KV pages apart from the fixed-size recurrent state, from
    ``meta`` shapes (``serve.slot_cache_bytes``): nothing is allocated."""
    from ..models.model import DecoderLM
    from ..serve import slot_cache_bytes

    print(f"# serve cache report: {max_slots} slots x page {page_len}")
    print("arch,per_slot_MiB,kv_pages_MiB,recurrent_MiB,total_GiB")
    rows = []
    for arch in archs:
        model = DecoderLM(get_config(arch), device="meta")
        sb = slot_cache_bytes(model, max_slots, page_len)
        rows.append({"arch": arch, **sb})
        print(f"{arch},{sb['per_slot']/2**20:.1f},{sb['kv_pages']/2**20:.1f},"
              f"{sb['recurrent']/2**20:.1f},{sb['total']/2**30:.2f}")
    return rows


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------
def _run_cell(arch: str, shape: str, multi_pod: bool):
    """One cell in a worker process: its dict, a skip or a failure."""
    torch.set_num_threads(1)
    mesh = make_production_mesh(multi_pod=multi_pod)
    name = mesh_name(mesh)
    try:
        return "ok", lower_cell(arch, shape, mesh).to_dict()
    except SkipCell as e:
        print(f"[{arch} × {shape} × {name}] SKIP: {e}", flush=True)
        return "skip", {"arch": arch, "shape": shape, "mesh": name, "skipped": str(e)}
    except Exception as e:  # noqa: BLE001 - reported with the cell, the sweep goes on
        traceback.print_exc()
        return "fail", (arch, shape, name, repr(e))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="merge JSON results into this file")
    ap.add_argument("--serve-cache-report", action="store_true",
                    help="print slot-cache byte costs (meta shapes only; "
                         "nothing allocated) and exit")
    ap.add_argument("--serve-slots", type=int, default=128)
    ap.add_argument("--serve-page-len", type=int, default=32_768)
    ap.add_argument("--workers", type=int, default=1,
                    help="cells costed in parallel processes (one thread each)")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if args.all or not args.arch else [args.arch]
    if args.serve_cache_report:
        serve_cache_report(archs, args.serve_slots, args.serve_page_len)
        return
    pods = [False, True] if args.both_meshes else [args.multi_pod]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    cells = [(arch, shape, pod) for pod in pods for arch in archs for shape in shapes]

    results, failures = [], []
    if args.workers > 1:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(args.workers, mp_context=ctx) as pool:
            outcomes = list(pool.map(_run_cell, *zip(*cells)))
    else:
        outcomes = [_run_cell(*cell) for cell in cells]
    for kind, value in outcomes:
        if kind == "fail":
            failures.append(value)
        else:
            results.append(value)

    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        keyf = lambda d: (d["arch"], d["shape"], d["mesh"])  # noqa: E731
        keep = {keyf(d): d for d in existing}
        for d in results:
            keep[keyf(d)] = d
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(list(keep.values()), f, indent=1)
        print(f"wrote {len(results)} results to {args.out}")

    if failures:
        print("FAILURES:")
        for f_ in failures:
            print(" ", f_)
        sys.exit(1)


if __name__ == "__main__":
    main()
