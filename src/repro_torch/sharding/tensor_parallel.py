"""The model axis: heads, MLP channels, Mamba channels, RWKV6's heads and
channels, the MoE experts' channels and the vocabulary split across ranks
(Megatron's column/row split), and KV caches split by sequence.

JAX's table maps ``act_heads``, ``act_kv_heads``, ``act_mlp`` and
``act_vocab`` to "model" (``sharding/rules.py``) and XLA runs each rank on
its own block of heads, channels and vocabulary.  The port does it by hand:
under rules that map such a name to a mesh axis of size M > 1 over a
``DeviceMesh``, a module reads the rank's block of its weights and computes
on that block alone.

  * **Which split.**  ``AxisRules.split_axis`` follows ``AxisRules.spec(...,
    allow_uneven=True)`` on the activation's logical name: where the rule
    drops the split, the tensor is replicated.  Heads and channels are split
    only where they divide M (a padded uneven split of heads is replicated
    instead: a departure, qwen2-vl's 28 heads over 16); the vocabulary keeps
    ``allow_uneven``'s padded blocks of ``ceil(V / M)``.  Where the KV heads
    stay whole, ``cache_seq`` on one mesh axis splits the KV caches' rows
    (``models/attention.py``: a decode step's softmax combined across ranks
    by an all-reduced max and sums).  The goom layer and
    Mamba (``scans=True``) keep whole heads and channels under rules that
    time-shard the scans on that same axis.
  * **Forward collectives.**  An activation enters a split region through
    :func:`enter` (the identity; its backward all-reduces the partial
    gradients over the model group) and partial sums leave one through
    :func:`leave` (an all-reduce; its backward the identity).
    :func:`reduce` is both (Mamba's (Δ, B, C) leave ``x_proj`` and enter
    the channels' scan).  Sums run in f32 (a bf16 activation is cast up and
    back), so two partials are rounded once.
  * **Parameters.**  A module says which of its weights it reads a block of
    (``split_dims``: the tensor dim, or None for a weight read whole whose
    use differs rank by rank).  ``ParamGather`` leaves such a block
    ungathered where the layout already splits that dim on the axis, and
    otherwise gathers the weight and sums its gradient over the axis
    (``sharding/gather.py``); plain parameters read so get :func:`sum_grad`.
    The module then takes its block with :meth:`Split.take`, from the whole
    or from the block alike.
  * **The vocabulary.**  :func:`embedding` looks up the rank's rows (the
    others masked to zero) and all-reduces; :func:`split_nll` is the summed
    NLL of vocabulary-split logits (each rank's log-sum-exp all-gathered,
    the gold logit from the rank that owns it, all-reduced), so the loss
    never makes whole logits; :func:`gather_last` makes whole logits where
    a caller wants them (prefill).

Every collective is ``torch.distributed``'s raw one on the tensor's
device, as in ``sharding/gather.py`` (gloo carries them for CUDA tensors);
one that fails raises.  :func:`listening` reports each (kind, bytes of its
result, group size) to the dry-run (``launch/cost.py``): over torch's fake
process group they move nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .rules import AxisRules, current_rules

__all__ = ["Split", "split_of", "split_on", "enter", "leave", "reduce",
           "sum_grad", "all_max", "gather_last", "embedding", "split_nll", "listening"]

@dataclasses.dataclass(frozen=True)
class Split:
    """This rank's place on the mesh axis a logical activation is split on."""

    axis: str
    mesh_dim: int     # the axis's index in the mesh
    size: int         # M, the ranks along it
    index: int        # this rank's index along it
    group: Any        # its process group

    def block(self, n: int) -> Tuple[int, int]:
        """(first, count) of this rank's block of a dim of ``n``: blocks of
        ``ceil(n / M)``, the last ones short where M does not divide n."""
        k = -(-n // self.size)
        lo = min(self.index * k, n)
        return lo, min(k, n - lo)

    def take(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """This rank's block of ``x``'s ``dim`` (``n`` whole): ``x`` is the
        whole tensor or already the block."""
        lo, k = self.block(n)
        if x.shape[dim] == n and k != n:
            return x.narrow(dim, lo, k)
        if x.shape[dim] != k:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} is neither {n} nor the "
                             f"block of {k}")
        return x


def split_on(rules: AxisRules, axis: str) -> Split:
    """The :class:`Split` of ``axis`` of the rules' ``DeviceMesh``."""
    mesh = rules.mesh
    return Split(axis, mesh.axis_names.index(axis), mesh.shape[axis],
                 mesh.get_local_rank(axis), mesh.get_group(axis))


def split_of(name: str, n: int, *, scans: bool = False) -> Optional[Split]:
    """The active rules' split of ``name`` (a dim of ``n``) on this rank, or
    None: no rules, an abstract mesh, or no split (``AxisRules.split_axis``)."""
    rules = current_rules()
    if rules is None or getattr(rules.mesh, "device_mesh", None) is None:
        return None
    axis = rules.split_axis(name, n, scans=scans)
    return None if axis is None else split_on(rules, axis)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
_listener: Optional[Callable[[str, int, int], None]] = None


@contextlib.contextmanager
def listening(fn: Callable[[str, int, int], None]):
    """Call ``fn(kind, result bytes, group size)`` for each collective of
    this module inside (in place of any listener outside)."""
    global _listener
    prev, _listener = _listener, fn
    try:
        yield
    finally:
        _listener = prev


def _report(kind: str, t: torch.Tensor, size: int) -> None:
    if _listener is not None:
        _listener(kind, t.numel() * t.element_size(), size)


def _all_reduce(x: torch.Tensor, sp: Split, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of every rank's ``x`` over the split's group, in
    a new tensor; in f32 for a narrower float."""
    wide = x.float() if x.is_floating_point() and x.element_size() < 4 else x
    y = wide.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=sp.group)
    _report("all-reduce", y, sp.size)
    return y.to(x.dtype)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.sp), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        return _all_reduce(x, sp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return _all_reduce(x, sp)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.sp), None


def enter(x: torch.Tensor, sp: Optional[Split]) -> torch.Tensor:
    """``x`` entering a split region: itself; its gradient summed over the
    group (each rank's is partial)."""
    return x if sp is None else _Enter.apply(x, sp)


def leave(x: torch.Tensor, sp: Optional[Split]) -> torch.Tensor:
    """Partial sums leaving a split region: their sum over the group; the
    gradient as it is (every rank's is whole)."""
    return x if sp is None else _Leave.apply(x, sp)


def reduce(x: torch.Tensor, sp: Optional[Split]) -> torch.Tensor:
    """Partial sums leaving one split region into another: summed over the
    group forward and backward."""
    return x if sp is None else _Reduce.apply(x, sp)


def sum_grad(p: torch.Tensor, sp: Split) -> torch.Tensor:
    """A plain parameter read by a split module: itself, its gradient summed
    over the group (each rank's covers its own use)."""
    return _Enter.apply(p, sp)


@torch.no_grad()
def all_max(x: torch.Tensor, sp: Optional[Split]) -> torch.Tensor:
    """The elementwise max of every rank's ``x`` over the group (no
    gradient: the max is a shift, detached where it is used)."""
    return x if sp is None else _all_reduce(x.detach(), sp, dist.ReduceOp.MAX)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, n):
        lo, k = sp.block(n)
        ctx.block = (lo, x.shape[-1])
        full = -(-n // sp.size)
        src = F.pad(x, (0, full - x.shape[-1])).movedim(-1, 0).contiguous()
        out = src.new_empty((sp.size * full,) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=sp.group)
        _report("all-gather", out, sp.size)
        return out[:n].movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        lo, k = ctx.block
        return g.narrow(-1, lo, k), None, None


def gather_last(x: torch.Tensor, sp: Optional[Split], n: int) -> torch.Tensor:
    """Whole (..., n) from each rank's block of the last dim (an
    all-gather); the gradient's block back."""
    return x if sp is None else _GatherLast.apply(x, sp, n)


# ---------------------------------------------------------------------------
# the vocabulary
# ---------------------------------------------------------------------------
def embedding(tokens: torch.Tensor, w: torch.Tensor, sp: Optional[Split],
              vocab: int) -> torch.Tensor:
    """``F.embedding(tokens, w)`` with the vocabulary split: the rank's rows
    of ``w`` (whole or the block) looked up, the tokens it does not own
    masked to zero, then summed over the group."""
    if sp is None:
        return F.embedding(tokens, w)
    lo, k = sp.block(vocab)
    local = tokens - lo
    own = (local >= 0) & (local < k)
    x = F.embedding(local.clamp(0, max(k - 1, 0)), sp.take(w, 0, vocab))
    return leave(torch.where(own[..., None], x, x.new_zeros(())), sp)


def _stacked(x: torch.Tensor, sp: Split) -> torch.Tensor:
    """(M, *x.shape): every rank's ``x`` in rank order (an all-gather)."""
    out = x.new_empty((sp.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=sp.group)
    _report("all-gather", out, sp.size)
    return out.view((sp.size,) + tuple(x.shape))


class _SplitNll(torch.autograd.Function):
    """The summed NLL of vocabulary-split logits (f32 or wider) and its
    gradient, softmax minus the one-hot of the gold label on its owner.
    Each rank's log-sum-exp over its block is all-gathered and the whole
    one is their log-sum-exp; the rank's share of the softmax is its local
    softmax times its block's share of the partition function."""

    @staticmethod
    def forward(ctx, logits, labels, lo, sp):
        k = logits.shape[-1]
        parts = _stacked(torch.logsumexp(logits, dim=-1), sp)      # (M, B, k)
        logz = torch.logsumexp(parts, dim=0)
        lab = labels.clamp_min(0).long() - lo
        own = (lab >= 0) & (lab < k)
        at = lab.clamp(0, max(k - 1, 0))[..., None]
        gold = _all_reduce(torch.where(own, logits.gather(-1, at)[..., 0], 0.0), sp)
        mask = (labels >= 0).to(logits.dtype)
        share = torch.softmax(parts, dim=0)[sp.index]
        ctx.save_for_backward(logits, share, at, own, mask)
        return ((logz - gold) * mask).sum()

    @staticmethod
    def backward(ctx, g):
        logits, share, at, own, mask = ctx.saved_tensors
        p = torch.softmax(logits, dim=-1) * share[..., None]
        p.scatter_add_(-1, at, -own.to(p.dtype)[..., None])
        return p * (g * mask)[..., None], None, None, None


def split_nll(logits: torch.Tensor, labels: torch.Tensor, sp: Split, vocab: int
              ) -> torch.Tensor:
    """The summed NLL of ``labels`` (-1 masked) under the rank's block of
    the logits (``sp.block(vocab)``), equal to whole logits'."""
    return _SplitNll.apply(logits, labels, sp.block(vocab)[0], sp)
