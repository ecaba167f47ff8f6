"""Which collectives gloo carries for CUDA tensors, raw and through DTensor.

Two gloo ranks share ``cuda:0``; each probe runs in its own pair of ranks
(``repro_torch.launch.mesh.spawn_ranks``), so one that kills its ranks does
not hide the next.  Run on a machine with a card, from the repository root:

    python tools/dtensor_gloo_probe.py [PROBE ...]

(the probes named, by default all of ``STEPS``).  Each line names the process-group backend, the probe, and the ranks'
results or how they failed.  On an NVIDIA H100 with torch 2.11.0+cu128 the
raw ``all_gather``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``
and ``all_reduce`` ran, as
did DTensor's ``Partial`` -> ``Replicate``, ``Partial`` -> ``Shard`` and
``distribute_tensor``; the functional ``all_gather_tensor``, and with it
DTensor's ``Shard`` -> ``Replicate`` (a parameter's gather), ended both
ranks with SIGSEGV, under ``gloo`` and ``cpu:gloo,cuda:gloo`` alike.

The port avoids the failing calls where it gathers parameters: the FSDP
step's gather of each period's parameters, its gradients' reduction,
checkpoints' and int8's gathers run on the raw calls that ran
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``;
``repro_torch.sharding.gather``, as ``repro_torch.kernels.sharded`` carries
the scans' time shards on ``all_gather`` and ``all_reduce``), and DTensor is left only ``Partial`` -> ``Replicate`` (the
metrics, the clip's norm) and ``distribute_tensor``.  So gloo ranks that
share a card lay their parameters out.  The time shards of
``--seq-shards`` still redistribute through DTensor's ``Shard`` ->
``Replicate``: there those ranks keep the plain layout.
"""

import json
import pathlib
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

STEPS = ["mesh", "allgather_raw", "allgather_into", "reduce_scatter_raw", "allreduce_raw",
         "funcol_allgather", "shard_to_rep", "partial_to_rep", "partial_to_shard",
         "distribute"]


def probe(rank, step):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    torch.cuda.set_device(0)
    x = torch.arange(6., device="cuda")
    if step == "allgather_raw":
        parts = [torch.empty(3, device="cuda") for _ in range(2)]
        dist.all_gather(parts, x[:3].clone())
        torch.cuda.synchronize()
        return [p.tolist() for p in parts]
    if step == "allgather_into":
        out = torch.empty(6, device="cuda")
        dist.all_gather_into_tensor(out, x[:3].clone())
        torch.cuda.synchronize()
        return out.tolist()
    if step == "reduce_scatter_raw":
        out = torch.empty(3, device="cuda")
        dist.reduce_scatter_tensor(out, x * (rank + 1))
        torch.cuda.synchronize()
        return out.tolist()
    if step == "allreduce_raw":
        y = x.clone()
        dist.all_reduce(y)
        torch.cuda.synchronize()
        return y.tolist()
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("data",))
    if step == "mesh":
        return "ok"
    if step == "funcol_allgather":
        import torch.distributed._functional_collectives as fc

        out = fc.all_gather_tensor(x[:3].clone(), 0, mesh)
        return (out.wait() if hasattr(out, "wait") else out).tolist()
    if step == "shard_to_rep":
        d = DTensor.from_local(x[rank * 3:(rank + 1) * 3].clone(), mesh, [Shard(0)])
        return d.redistribute(mesh, [Replicate()]).to_local().tolist()
    if step == "partial_to_rep":
        d = DTensor.from_local(x.clone(), mesh, [Partial()])
        return d.redistribute(mesh, [Replicate()]).to_local().tolist()
    if step == "partial_to_shard":
        d = DTensor.from_local(x.clone(), mesh, [Partial()])
        return d.redistribute(mesh, [Shard(0)]).to_local().tolist()
    assert step == "distribute", step
    return distribute_tensor(x, mesh, [Shard(0)]).to_local().tolist()


def main(steps=STEPS):
    from repro_torch.launch.mesh import spawn_ranks

    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    for backend in ("gloo", "cpu:gloo,cuda:gloo"):
        for step in steps:
            try:
                res = spawn_ranks(probe, 2, step, backend=backend, timeout=60)
                print(backend, step, json.dumps(res), flush=True)
            except Exception as e:   # a probe that kills its ranks
                print(backend, step, "FAILED", repr(e)[:300], flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or STEPS)
