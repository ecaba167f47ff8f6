"""The train step: forward and backward, the global-norm clip, the
optimizer update; with gradient accumulation over microbatches.

The port of ``repro/train/train_loop.py``.  ``cast_params_bf16`` casts
the f32 parameters to bf16 before the forward (JAX's perf option): laid
out as DTensors, the cast runs on each rank's blocks *before* the gather,
so the gather moves bf16 and the gradients are reduce-scattered in bf16,
then cast back to the parameters' f32.  ``constrain_grads`` has no switch
here: the DTensor step always reduce-scatters the gradients into the
parameters' layout (JAX's ``grad_shardings``).
Distribution takes one of two forms:

  * data parallel over ``data_group`` (a ``torch.distributed`` group whose
    ranks hold the same plain parameters and each a slice of the global
    batch): the gradients are averaged over it before the clip (under
    rules that split the model axis, a split module's gradient is summed
    over that axis in the backward, so every rank holds it whole);
  * parameters laid out as DTensors (``sharding.distribute_model``: JAX's
    ``param_shardings``, FSDP over the data axes and the model axis's
    splits): the model gathers each period's parameters as it enters the
    period, and the embedding, final norm and head around their use
    (``sharding/gather.py``, ``DecoderLM.hidden_states``), as XLA places
    JAX's gathers inside its scan over periods; each microbatch gathers
    again.  The gather's backward puts each gradient into its parameter's
    layout (summed over the batch axes: a reduce-scatter where the
    parameter is split on one, an all-reduce where it is replicated), and
    the step divides by their size: the mean, once.  Each rank runs on its
    slice of the batch.  The moments follow their parameters (JAX's
    ``state_shardings``), the global-norm clip sums over every shard, and
    the update runs on each rank's blocks.  Under rules that split heads,
    channels or the vocabulary on the model axis, each rank of it computes
    its block (``sharding/tensor_parallel.py``): a split module's weights
    reach it as the rank's block, gathered over the batch axes only, and
    their gradients stay that block; the clip's sum of squares counts a
    split leaf once a block and a replicated one once
    (``optimizer.global_norm``).  The step's gather is
    ``train_step.param_gather`` (it counts the gathered bytes alive).

Sequence sharding needs nothing here: under the launcher's rules the
recurrent layers time-shard their scans (``sharding/layout.py``) and sum
the gradients of what they read over the seq group.  ``grad_compression="int8"`` rounds the averaged
gradients through ``compress_int8`` / ``decompress_int8``, as the JAX step
does after GSPMD's reduction; laid-out gradients are gathered whole for it
(``sharding.gather.full_tensor``, as checkpoints gather every leaf).
``make_train_step`` returns
``train_step(state, batch) -> (state, metrics)``; ``state.params`` are the
model's own parameters, updated in place, so the state returned is the one
passed in, advanced by a step.

The JAX ``TrainState`` also carries an ``rng`` leaf, folded with the step
each update; no model the port has reads it (no dropout, no sampling in
training), so the port carries none.  A checkpoint written by the JAX
package restores here without it, and one written here restores in the
JAX package into a ``{params, opt_state, step}`` target.

``state_tree`` and ``load_state_tree`` map a state to and from the JAX
TrainState's tree (params with each group's periods stacked, the moments
likewise, the optimizer step and the step as int32), which is what the
checkpoint stores.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..configs.base import LMConfig
from ..convert import params_from_jax, params_to_jax
from ..models.model import DecoderLM
from ..sharding.gather import ParamGather, batch_mesh_dims, full_tensor
from ..sharding.rules import is_dtensor
from .optimizer import clip_by_global_norm, compress_int8, decompress_int8

Batch = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # the model's parameters, by port name
    opt_state: Dict[str, Any]         # moments keyed like params, and "step"
    step: int


def init_train_state(model: DecoderLM, optimizer) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def _sum_over(flat: torch.Tensor, group) -> torch.Tensor:
    """One all-reduce of ``flat`` (a tensor of this module's own) over
    ``group``, in place on its device (gloo's too, as
    ``sharding/gather.py``)."""
    import torch.distributed as dist

    dist.all_reduce(flat, group=group)
    return flat


def mean_over(grads: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The mean of each gradient over the ranks of ``group``, in place, in
    one f32 all-reduce of all of them."""
    import torch.distributed as dist

    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1).float() for n in names])
    flat = _sum_over(flat, group) / dist.get_world_size(group)
    for n, part in zip(names, flat.split([grads[n].numel() for n in names])):
        grads[n] = part.view_as(grads[n]).to(grads[n].dtype)
    return grads


def _metrics_over(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The global batch's metrics from each rank's slice: ``tokens`` summed,
    the rest averaged (every slice holds as many labelled tokens)."""
    import torch.distributed as dist

    names = list(metrics)
    tot = _sum_over(torch.stack([metrics[n].float() for n in names]), group)
    n = dist.get_world_size(group)
    return {k: v if k == "tokens" else v / n for k, v in zip(names, tot)}


def _sum_over_dims(x: torch.Tensor, mesh, dims: Tuple[int, ...]) -> torch.Tensor:
    """The sum of every rank's ``x`` over the mesh dims ``dims``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    pl = [Partial() if i in dims else Replicate() for i in range(mesh.ndim)]
    return DTensor.from_local(x, mesh, pl, run_check=False).full_tensor()


def make_train_step(model: DecoderLM, optimizer, *, max_grad_norm: float = 1.0,
                    microbatches: int = 1, grad_compression: Optional[str] = None,
                    data_group=None, rules=None, cast_params_bf16: bool = False
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict]]:
    """The train step over ``batch`` = {tokens, labels}, both (B, S) with B
    a multiple of ``microbatches``; any other key (a frontend's
    ``prefix_embeds`` (B, P, d), ``mrope_positions`` (3, B, S)) goes to
    ``model.loss``, split with the batch (``mrope_positions`` along its dim
    1).  Metrics: the loss's (averaged over microbatches, this rank's batch
    slice), ``grad_norm`` before the clip and ``lr = schedule(step+1)``, the
    rate the update used.  ``data_group``: average the gradients over its
    ranks, and the metrics (``tokens`` summed); ``grad_compression``: None or
    ``"int8"``.  With DTensor parameters, ``rules`` (the ones they were laid
    out by) name the batch axes the gradients and metrics are reduced over;
    ``data_group`` must then be None.  ``cast_params_bf16``: the forward
    runs on bf16 copies of the f32 parameters (module docstring)."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}; None or 'int8'")
    decay = optimizer.decay_mask(model.cfg, [n for n, _ in model.named_parameters()])
    sharded = any(is_dtensor(p) for p in model.parameters())
    param_gather = None
    if sharded:
        if rules is None or data_group is not None:
            raise ValueError("DTensor parameters take the rules they were laid out by "
                             "and no data_group (their gather reduces the gradients)")
        mesh = next(iter(model.parameters())).device_mesh
        batch_dims = batch_mesh_dims(mesh.mesh_dim_names, rules)
        n_batch = 1
        for i in batch_dims:
            n_batch *= mesh.size(i)
        param_gather = ParamGather(batch_dims,
                                   dtype=torch.bfloat16 if cast_params_bf16 else None)

    def cast(p):
        return p.to(torch.bfloat16) if cast_params_bf16 and p.dtype == torch.float32 else p

    def grads_of(params, tokens, labels, **kw):
        from torch.nn.utils.stateless import _reparametrize_module

        names = list(params)
        if not sharded and not cast_params_bf16:
            loss, metrics = model.loss(tokens, labels, **kw)
            grads = torch.autograd.grad(loss, [params[n] for n in names])
        elif not sharded:
            with _reparametrize_module(model, {n: cast(params[n]) for n in names}):
                loss, metrics = model.loss(tokens, labels, **kw)
                grads = torch.autograd.grad(loss, [params[n] for n in names])
        else:
            # the backward stays inside: remat re-runs a period's gather
            loss, metrics = model.loss(tokens, labels, param_gather=param_gather, **kw)
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            grads = [g / n_batch for g in grads]
        return dict(zip(names, grads)), {k: v.detach() for k, v in metrics.items()}

    def compute_grads(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        kw = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
        if microbatches == 1:
            return grads_of(params, tokens, labels, **kw)
        if tokens.shape[0] % microbatches:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{microbatches} microbatches")
        k = tokens.shape[0] // microbatches
        acc = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        per_mb = []
        for i in range(microbatches):
            part = slice(i * k, (i + 1) * k)
            grads, metrics = grads_of(params, tokens[part], labels[part], **{
                name: v[:, part] if name == "mrope_positions" else v[part]
                for name, v in kw.items()})
            names = list(acc)
            torch._foreach_add_([acc[n] for n in names],
                                torch._foreach_div([grads[n].float() for n in names],
                                                   float(microbatches)))
            per_mb.append(metrics)
        return acc, {key: torch.stack([m[key] for m in per_mb]).mean() for key in per_mb[0]}

    def train_step(state: TrainState, batch: Batch):
        grads, metrics = compute_grads(state.params, batch)
        if data_group is not None:
            grads = mean_over(grads, data_group)
            metrics = _metrics_over(metrics, data_group)
        if sharded and n_batch > 1:
            names = list(metrics)
            tot = _sum_over_dims(torch.stack([metrics[k].float() for k in names]), mesh,
                                 batch_dims)
            metrics = {k: v if k == "tokens" else v / n_batch for k, v in zip(names, tot)}
        if grad_compression == "int8":
            whole = {n: full_tensor(g) for n, g in grads.items()}
            grads = {n: _like(g.to(state.params[n].dtype), grads[n])
                     for n, g in decompress_int8(compress_int8(whole)).items()}
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        params, opt_state = optimizer.update(grads, state.opt_state, state.params, decay)
        metrics = dict(metrics, grad_norm=gnorm, lr=optimizer.schedule(state.step + 1))
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), metrics

    train_step.param_gather = param_gather
    return train_step


def _like(full: torch.Tensor, ref) -> torch.Tensor:
    """``full`` laid out as ``ref`` (this rank's block of it, no collective)
    when ``ref`` is a DTensor, else ``full``."""
    if not is_dtensor(ref):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(ref.device), ref.device_mesh, ref.placements,
                             src_data_rank=None)


def _whole(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: full_tensor(v) for n, v in tree.items()}


def state_tree(cfg: LMConfig, state: TrainState) -> Dict[str, Any]:
    """The JAX TrainState's tree of ``state`` (without ``rng``), as numpy.
    DTensor leaves are gathered whole first: every rank of their mesh must
    call it (one of them then writes the checkpoint)."""
    opt = {k: (np.asarray(v, np.int32) if k == "step" else params_to_jax(cfg, _whole(v)))
           for k, v in state.opt_state.items()}
    return {"params": params_to_jax(cfg, _whole(state.params)), "opt_state": opt,
            "step": np.asarray(state.step, np.int32)}


@torch.no_grad()
def load_state_tree(cfg: LMConfig, state: TrainState, tree: Dict[str, Any]) -> TrainState:
    """Copy a JAX-layout tree (``state_tree``'s, or a JAX checkpoint's) into
    ``state``'s tensors (a DTensor's block from the whole leaf, so a
    checkpoint restores at another rank count, as JAX's elastic restart
    reshards); returns the state at the tree's step."""
    def load(dst: Dict[str, torch.Tensor], src):
        for name, v in params_from_jax(cfg, src).items():
            if tuple(v.shape) != tuple(dst[name].shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(v.shape)} != "
                                 f"{tuple(dst[name].shape)}")
            if is_dtensor(dst[name]):   # this rank's block, at any rank count
                dst[name].to_local().copy_(_like(v, dst[name]).to_local())
            else:
                dst[name].copy_(v)

    load(state.params, tree["params"])
    opt = dict(state.opt_state)
    for k, v in tree["opt_state"].items():
        if k == "step":
            opt[k] = int(v)
        else:
            load(opt[k], v)
    return TrainState(params=state.params, opt_state=opt, step=int(tree["step"]))
