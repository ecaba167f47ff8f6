"""The train step: forward and backward, the global-norm clip, the
optimizer update; with gradient accumulation over microbatches.

The port of ``repro/train/train_loop.py`` without parameter sharding or bf16
parameter casting.  Distribution is data parallel over ``data_group`` (a
``torch.distributed`` group whose ranks hold the same parameters and each a
slice of the global batch): the gradients are averaged over it before the
clip.  Sequence sharding needs nothing here: the engine's sharded scans
leave every rank of the seq group with the whole gradient
(``kernels/sharded.py``).  ``grad_compression="int8"`` rounds the averaged
gradients through ``compress_int8`` / ``decompress_int8``, as the JAX step
does after GSPMD's reduction.  ``make_train_step`` returns
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
    """One all-reduce of ``flat`` over ``group`` (through host memory unless
    the group is NCCL's: gloo takes CPU tensors)."""
    import torch.distributed as dist

    wire = flat if "nccl" in str(dist.get_backend(group)) else flat.cpu()
    dist.all_reduce(wire, group=group)
    return wire.to(flat.device)


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


def make_train_step(model: DecoderLM, optimizer, *, max_grad_norm: float = 1.0,
                    microbatches: int = 1, grad_compression: Optional[str] = None,
                    data_group=None
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict]]:
    """The train step over ``batch`` = {tokens, labels}, both (B, S) with B
    a multiple of ``microbatches``; any other key (a frontend's
    ``prefix_embeds`` (B, P, d), ``mrope_positions`` (3, B, S)) goes to
    ``model.loss``, split with the batch (``mrope_positions`` along its dim
    1).  Metrics: the loss's (averaged over microbatches, this rank's batch
    slice), ``grad_norm`` before the clip and ``lr = schedule(step+1)``, the
    rate the update used.  ``data_group``: average the gradients over its
    ranks, and the metrics (``tokens`` summed); ``grad_compression``: None or
    ``"int8"``."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}; None or 'int8'")
    decay = optimizer.decay_mask(model.cfg, [n for n, _ in model.named_parameters()])

    def grads_of(params, tokens, labels, **kw):
        loss, metrics = model.loss(tokens, labels, **kw)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
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
        if grad_compression == "int8":
            grads = {n: g.to(state.params[n].dtype)
                     for n, g in decompress_int8(compress_int8(grads)).items()}
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        params, opt_state = optimizer.update(grads, state.opt_state, state.params, decay)
        metrics = dict(metrics, grad_norm=gnorm, lr=optimizer.schedule(state.step + 1))
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), metrics

    return train_step


def state_tree(cfg: LMConfig, state: TrainState) -> Dict[str, Any]:
    """The JAX TrainState's tree of ``state`` (without ``rng``), as numpy."""
    opt = {k: (np.asarray(v, np.int32) if k == "step" else params_to_jax(cfg, v))
           for k, v in state.opt_state.items()}
    return {"params": params_to_jax(cfg, state.params), "opt_state": opt,
            "step": np.asarray(state.step, np.int32)}


@torch.no_grad()
def load_state_tree(cfg: LMConfig, state: TrainState, tree: Dict[str, Any]) -> TrainState:
    """Copy a JAX-layout tree (``state_tree``'s, or a JAX checkpoint's) into
    ``state``'s tensors; returns the state at the tree's step."""
    def load(dst: Dict[str, torch.Tensor], src):
        for name, v in params_from_jax(cfg, src).items():
            if tuple(v.shape) != tuple(dst[name].shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(v.shape)} != "
                                 f"{tuple(dst[name].shape)}")
            dst[name].copy_(v)

    load(state.params, tree["params"])
    opt = dict(state.opt_state)
    for k, v in tree["opt_state"].items():
        if k == "step":
            opt[k] = int(v)
        else:
            load(opt[k], v)
    return TrainState(params=state.params, opt_state=opt, step=int(tree["step"]))
