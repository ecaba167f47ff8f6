"""Meshes of this host's ranks, and a way to run a function on P ranks.

``make_host_mesh(seq_shards)`` is the port of ``repro/launch/mesh.py``'s: the
world of ``torch.distributed`` as a ("data", "model") mesh of shape
(world / seq_shards, seq_shards), the "model" axis carrying the time shards
of sequence-sharded scans (the launcher maps the ``scan_seq`` logical axis
there).  A process that started no process group is a world of one.
``make_production_mesh(multi_pod)`` is the target deployment: (16, 16)
("data", "model") or (2, 16, 16) ("pod", "data", "model"), a ``DeviceMesh``
when the world has that many ranks and an abstract mesh (sizes and names,
as ``jax.sharding.AbstractMesh``) otherwise.

``spawn_ranks(fn, world, *args)`` starts ``world`` processes on this host
(``spawn``), joins them into one process group over
``tcp://localhost:<a free port>`` and returns each rank's ``fn(rank,
*args)``: the tests run sharded ops on gloo ranks on the CPU with it, and
``chip_smoke.py`` on gloo ranks that share the card.
"""

from __future__ import annotations

import math
import multiprocessing
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional

import torch.distributed as dist

from ..sharding.mesh import NamedMesh

__all__ = ["make_host_mesh", "make_production_mesh", "free_port", "spawn_ranks"]


def _device_mesh(sizes, names, device_type: Optional[str]) -> NamedMesh:
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return NamedMesh.of(init_device_mesh(device_type, tuple(sizes), mesh_dim_names=names))


def make_host_mesh(*, seq_shards: int = 1, device_type: Optional[str] = None) -> NamedMesh:
    """The ranks of this process group as a ("data", "model") mesh of shape
    (world / seq_shards, seq_shards); the world must divide evenly.
    ``device_type`` is the device of the tensors DTensors over the mesh hold
    (default: ``cuda`` under NCCL, else ``cpu``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % seq_shards:
        raise ValueError(f"--seq-shards {seq_shards} does not divide {world} processes")
    sizes = (world // seq_shards, seq_shards)
    if not dist.is_initialized():
        return NamedMesh(sizes, ("data", "model"))
    return _device_mesh(sizes, ("data", "model"), device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> NamedMesh:
    """256 ranks as (data=16, model=16), or with ``multi_pod`` 512 as (pod=2,
    data=16, model=16): the pod axis is pure data parallelism across the
    slower links between pods (``repro/launch/mesh.py``).  Over a process
    group of exactly that world it is a ``DeviceMesh``; otherwise an
    abstract mesh, sizes and names only (what the dry-run tools lay
    parameters out on; the launcher refuses to train on one)."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized() or dist.get_world_size() != math.prod(sizes):
        return NamedMesh(sizes, names)
    return _device_mesh(sizes, names, device_type)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str, fn, args, out) -> None:
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable[..., Any], world: int, *args, backend: str = "gloo",
                timeout: float = 600.0) -> List[Any]:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each run in its own
    process inside one process group.  ``fn`` must be importable (a module's
    top-level function); its result is pickled back.  A failing rank raises
    here with its traceback, and the other ranks are stopped."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, backend, fn, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn_ranks: ranks {dead} exited with codes "
                                       f"{[procs[r].exitcode for r in dead]} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn_ranks: {world - len(results)} of {world} "
                                       f"ranks gave no result in {timeout:.0f} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        out.close()
    return [results[r] for r in range(world)]
