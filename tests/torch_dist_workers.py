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
