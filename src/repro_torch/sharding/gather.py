"""A laid-out parameter gathered whole where the model reads it: FSDP's gather.

JAX leaves a step's parameter gathers to XLA, which places them inside the
``lax.scan`` over periods (``repro/models/blocks.py``): a device holds one
period's gathered parameters at a time.  The port does the same by hand:
``DecoderLM.hidden_states`` gathers each period's parameters as it enters
the period (inside the period's ``torch.utils.checkpoint`` region, so the
backward's recomputation gathers again and nothing gathered is saved), and
the embedding, final norm and head around their use.

:class:`ParamGather` turns a parameter laid out as a DTensor
(``sharding.distribute_model``) into a plain whole tensor, one mesh dim at
a time (the last mesh dim first, as DTensor undoes its splits), in an
autograd function whose backward puts the gradient back into the
parameter's layout: over each batch mesh dim a reduce-scatter where the
parameter is split on it, an all-reduce where it is replicated (the sum of
the ranks' batch slices); over the other mesh dims, where every rank
computes alike, this rank's slice, with no sum.  ``to_local``'s backward
then wraps the block as a DTensor of the parameter's placements.  A whole
gradient therefore lives from the period's backward to its reduction.

**The model axis.**  A parameter read by a module split across ranks
(``sharding/tensor_parallel.py``) comes with its role, ``(split, dim)``:
the module reads the rank's block of tensor dim ``dim``.  Where the layout
splits that dim on the split's mesh dim (and no other mesh dim splits it),
the block stays as it is: gathered over the batch dims only, its gradient
reduced over them and never sliced on the model dim.  Otherwise (``dim``
None: a weight read whole, as Mamba's [x; z] ``in_proj``; or a layout that
keeps the dim whole, as indivisible KV heads or vocabulary) the parameter
is gathered whole and its gradient summed over the model dim like a batch
dim, since each rank's covers only its own use.  A plain parameter with a
role gets the same sum (``tensor_parallel.sum_grad``).
With ``dtype`` (``cast_params_bf16``) each rank casts its block before
the gather, so the gather and the reduction move bf16.

**Transport.**  The collectives are ``torch.distributed``'s own
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``)
on the tensor's device, NCCL's and gloo's alike: gloo runs them on CUDA
tensors where DTensor's ``Shard`` -> ``Replicate`` (through the functional
collectives) ended its ranks (``tools/dtensor_gloo_probe.py``), as
``kernels/sharded.py`` carries the time shards' collectives.  A collective
that fails raises.

:func:`full_tensor` is the same gather without a gradient, for
checkpoints and the int8 round trip of laid-out gradients and moments.
The dry-run traces a rank's step with the parameters laid out over torch's
fake process group (``launch/dryrun.py``), where these collectives move
nothing and the trace allocates what a rank allocates.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .rules import is_dtensor
from .tensor_parallel import Split, sum_grad

__all__ = ["ParamGather", "full_tensor", "batch_mesh_dims"]

#: a split module's read of a parameter: the split and the tensor dim it
#: reads a block of (None: the whole)
Role = Tuple[Split, Optional[int]]


@dataclasses.dataclass(frozen=True)
class _MeshDim:
    """One mesh dim of a parameter's layout that splits or sums it."""

    size: int
    index: int                  # this rank's index along it
    group: Any                  # its process group
    shard: Optional[int]        # the tensor dim it splits; None: replicated on it
    batch: bool                 # a batch axis: the gradient is summed over it


def batch_mesh_dims(mesh_dim_names: Sequence[str], rules=None) -> Tuple[int, ...]:
    """The mesh dims of the batch axes: the rules' ``batch`` axes, or
    without rules the dims named "pod" and "data" (every table of
    ``sharding.rules`` puts the batch there)."""
    axes = rules.mesh_axes_for("batch") if rules is not None else ("pod", "data")
    return tuple(i for i, a in enumerate(mesh_dim_names) if a in axes)


def _plan(p, batch_dims: Tuple[int, ...], role: Optional[Role] = None
          ) -> Tuple[_MeshDim, ...]:
    """The mesh dims of a DTensor ``p`` of more than one rank, in mesh
    order, but the model dim whose block a split module reads (``role``,
    module docstring)."""
    mesh = p.device_mesh
    split, keep = role if role is not None else (None, None)
    shards = [pl.dim if pl.is_shard() else None for pl in p.placements]
    dims = []
    for i, pl in enumerate(p.placements):
        if not (pl.is_shard() or pl.is_replicate()):
            raise ValueError(f"a parameter's placement {pl} is neither Shard nor Replicate")
        n = mesh.size(i)
        shard = shards[i]
        if shard is not None and p.shape[shard] % n:
            raise ValueError(f"an uneven split of dim {shard} ({p.shape[shard]}) over {n}")
        if n == 1:
            continue
        model = split is not None and i == split.mesh_dim
        if model and keep is not None and shard == keep and shards.count(keep) == 1:
            continue                              # the module reads this block
        dims.append(_MeshDim(n, mesh.get_local_rank(i), mesh.get_group(i), shard,
                             i in batch_dims or model))
    return tuple(dims)


def _gather(x: torch.Tensor, plan: Tuple[_MeshDim, ...]) -> torch.Tensor:
    """The whole tensor from this rank's block, the last mesh dim first."""
    for d in reversed(plan):
        if d.shard is not None:
            src = x.movedim(d.shard, 0).contiguous()
            out = src.new_empty((d.size * src.shape[0],) + tuple(src.shape[1:]))
            dist.all_gather_into_tensor(out, src, group=d.group)
            x = out if d.shard == 0 else out.movedim(0, d.shard).contiguous()
    return x


def _scatter(g: torch.Tensor, plan: Tuple[_MeshDim, ...]) -> torch.Tensor:
    """A whole gradient into this rank's block, the first mesh dim first:
    summed over the batch dims, sliced on the others."""
    for d in plan:
        if d.shard is None:
            if d.batch:                           # replicated on a batch dim
                g = g.clone(memory_format=torch.contiguous_format)
                dist.all_reduce(g, group=d.group)
            continue
        k = g.shape[d.shard] // d.size
        if d.batch:
            src = g.movedim(d.shard, 0).contiguous()
            out = src.new_empty((k,) + tuple(src.shape[1:]))
            dist.reduce_scatter_tensor(out, src, group=d.group)
            g = out.movedim(0, d.shard)
        else:
            g = g.narrow(d.shard, d.index * k, k)
    if g.numel() * g.element_size() < g.untyped_storage().nbytes() or not g.is_contiguous():
        g = g.clone(memory_format=torch.contiguous_format)   # free the whole it sliced
    return g


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block: torch.Tensor, plan: Tuple[_MeshDim, ...]) -> torch.Tensor:
        ctx.plan = plan
        out = _gather(block, plan)
        return out if out is not block else block.view_as(block)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _scatter(grad, ctx.plan), None


class ParamGather:
    """Gathers laid-out parameters whole: ``gather(name, p)`` is ``p``'s
    whole value as a plain tensor (module docstring); the same on a plain
    ``p`` that holds no layout.  ``gather(name, p, role)``: as a split
    module reads it (the model axis, module docstring).

    ``batch_dims``: the mesh dims the gradients are summed over (default
    ``batch_mesh_dims`` of the parameter's mesh); ``dtype``: each rank's
    f32 block is cast to it before the gather (``cast_params_bf16``).
    ``live_bytes`` and ``peak_bytes`` count the gathered tensors alive, now
    and at most (a gather that splits nothing is not counted)."""

    def __init__(self, batch_dims: Optional[Tuple[int, ...]] = None, *,
                 dtype: Optional[torch.dtype] = None):
        self.batch_dims = batch_dims
        self.dtype = dtype
        self.live_bytes = 0
        self.peak_bytes = 0
        self._lock = threading.Lock()

    def __call__(self, name: str, p: torch.Tensor, role: Optional[Role] = None
                 ) -> torch.Tensor:
        if not is_dtensor(p):
            return p if role is None else sum_grad(p, role[0])
        dims = (self.batch_dims if self.batch_dims is not None
                else batch_mesh_dims(p.device_mesh.mesh_dim_names))
        plan, local = _plan(p, dims, role), p.to_local()
        if self.dtype is not None and local.dtype == torch.float32:
            local = local.to(self.dtype)
        if not plan:   # a view: the block itself can pass for a Parameter
            return local.view_as(local)
        whole = _Gather.apply(local, plan)
        if any(d.shard is not None for d in plan):
            self._count(whole)
        return whole

    def _count(self, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        with self._lock:
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(t, self._release, n)

    def _release(self, n: int) -> None:
        with self._lock:
            self.live_bytes -= n


@torch.no_grad()
def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor, on the port's collectives
    (``_gather``; no gradient); anything else as it is."""
    if not is_dtensor(x):
        return x
    return _gather(x.to_local(), _plan(x, ()))
