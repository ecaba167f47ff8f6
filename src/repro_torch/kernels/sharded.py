"""Sequence-sharded GOOM prefix scans over ``torch.distributed``.

The port of ``repro/kernels/sharded.py``.  The time axis of a recurrence is
split over one axis of a device mesh (``ShardSpec.seq_axis``); each rank
scans its time shard with the ordinary local implementation (the CUDA
kernels or the plain versions, whatever dispatch resolved), and the shards
are stitched with the same monoid one level up.  For ``X_t = A_t X_{t-1} ⊕
B_t`` the compound of a shard is (A*, B*) = (A_T ∘ ··· ∘ A_1, the last state
of the shard's scan from zero), and per rank:

  1. the local scan of the shard from zero -> states⁰_t;
  2. the local prefix products A*_t (``cumulative_lmme``, the zero-B kernel);
  3. an all-gather of the P carries (A*, B*) over the seq group;
  4. a scan over the P carries with the **plain** LMME (P tiny products, as
     JAX uses ``lmme_reference`` there);
  5. the exclusive prefix: this shard's entering compound, applied to x0;
  6. the stitch ``X_t = A*_t ∘ X_in ⊕ states⁰_t`` through the engine's LMME.

A length that the shard count does not divide is padded with identity steps
(A = I at log 0, B = exact zero at log -inf) and cut back; a length below
the shard count runs locally.

Each step of the algebra is a per-shard body (``matrix_scan_shard``,
``cumulative_lmme_shard``, ``diagonal_scan_shard``: JAX's ``shard_map``
bodies), which two front ends call:

  * ``mapped_*``: the operands are DTensors sharded along time over the seq
    axis and the states come back so (JAX's ``in_specs=t_spec``,
    ``out_specs=t_spec``); ``local_map`` hands the body each rank's local
    tensors.  The models take this form under the launcher's rules
    (``sharding/layout.py``): a rank builds its shard's operands only.
  * ``seq_sharded_*``: every rank of the seq group holds the full-length
    operands, scans its time shard and returns the full-length states,
    gathered from the group (``engine.use_mesh`` on plain tensors; gloo
    ranks that share a card, whose collectives DTensor cannot run).

The data axis splits the batch at the launcher, not inside the op, so
``batch_axes`` adds no collective, as in JAX.

**Gradients.**  The carries' gather (``_Gather`` with ``reduce``) sums the
gradients over the group and takes the rank's slice, in both forms.  In
the full-length form the code around the op runs alike on every rank, so
the op's inputs and outputs are replicated over the seq group and their
gradients must be whole on every rank:

  * the output gather's backward takes the rank's own slice of the (equal)
    upstream gradient: ``torch.distributed.nn``'s all-gather would sum it
    over ranks, P times the gradient;
  * the carry gather's backward all-reduces the sum of the gradients, then
    takes the rank's slice: every later shard's states depend on the
    earlier shards' carries;
  * each input's gradient (a rank fills only its shard's part of it, and
    only its own share of x0's) is all-reduced to the sum.

In the time-sharded form each shard's gradient stays on its rank, and
x0's (read by every rank's stitch) is ``Partial`` over the seq axis, which
DTensor's autograd sums.

**Transport.**  The collectives are ``torch.distributed``'s own on the
tensors' device, NCCL's and gloo's alike (gloo runs ``all_gather`` and
``all_reduce`` on CUDA tensors; ``tools/dtensor_gloo_probe.py``), as
``sharding/gather.py`` carries a parameter's gather.  ``collectives``
counts the calls, which is how a serving step tells that it holds one (a
replayed CUDA graph cannot).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.goom import Goom, goom_ones, goom_zeros
from ..core.ops import goom_add, goom_mul, lmme_reference
from ..core.scan import associative_scan

__all__ = ["ShardSpec", "seq_sharded_diagonal_scan", "seq_sharded_matrix_scan",
           "seq_sharded_cumulative_lmme", "seq_sharded_associative_scan",
           "mapped_diagonal_scan", "mapped_matrix_scan", "mapped_cumulative_lmme",
           "collectives"]

#: collective calls (all-gathers and all-reduces) since the last reset
collectives = {"n": 0}


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Where sharded scans run: a mesh (``sharding.NamedMesh``), the axis
    whose group carries the time shards, and the batch axes (no collective
    crosses them: the launcher split the batch)."""

    mesh: object
    seq_axis: str
    batch_axes: Tuple[str, ...] = ()

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape[self.seq_axis])

    @property
    def group(self):
        return self.mesh.get_group(self.seq_axis)

    @property
    def index(self) -> int:
        return self.mesh.get_local_rank(self.seq_axis)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(P,) + x.shape: every rank's ``x``, in rank order, on x's device."""
    collectives["n"] += 1
    as_bool = x.dtype == torch.bool
    w = x.detach().to(torch.uint8 if as_bool else x.dtype).contiguous()
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    out = torch.stack(parts)
    return out.bool() if as_bool else out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x``, on x's device."""
    collectives["n"] += 1
    w = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(w, group=group)
    return w


class _Gather(torch.autograd.Function):
    """All-gather of a replicated computation's shards.  Backward: the rank's
    slice of the upstream gradient, summed over the group first when
    ``reduce`` (the carries: later shards' states depend on them)."""

    @staticmethod
    def forward(ctx, x, spec, reduce):
        ctx.spec, ctx.reduce = spec, reduce
        return _all_gather(x, spec.group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            g = _all_reduce(g, ctx.spec.group)
        return g[ctx.spec.index], None, None


class _SumGrad(torch.autograd.Function):
    """Identity; backward all-reduces the gradient to its sum over the group,
    so that a replicated input's gradient is whole on every rank."""

    @staticmethod
    def forward(ctx, x, spec):
        ctx.spec = spec
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.spec.group), None


def _gather(x: torch.Tensor, spec: ShardSpec, reduce: bool = False) -> torch.Tensor:
    if x.requires_grad:
        return _Gather.apply(x, spec, reduce)
    return _all_gather(x, spec.group)


def _g_gather(g: Goom, spec: ShardSpec, reduce: bool = False) -> Goom:
    return Goom(_gather(g.log_abs, spec, reduce), _gather(g.sign, spec))


def _replicated(g: Optional[Goom], spec: ShardSpec) -> Optional[Goom]:
    """``g`` with its log plane's gradient summed over the group."""
    if g is None or not g.log_abs.requires_grad:
        return g
    return Goom(_SumGrad.apply(g.log_abs, spec), g.sign)


def _unshard(g: Goom, spec: ShardSpec, t: int) -> Goom:
    """The full-length states from every rank's (T/P, ...) shard, cut to t."""
    full = _g_gather(g, spec)
    return Goom(full.log_abs.flatten(0, 1)[:t], full.sign.flatten(0, 1)[:t])


# ---------------------------------------------------------------------------
# small Goom helpers
# ---------------------------------------------------------------------------
def _g_expand(g: Goom, shape) -> Goom:
    return Goom(g.log_abs.expand(shape), g.sign.expand(shape))


def _g_cat(gs: Sequence[Goom]) -> Goom:
    return Goom(torch.cat([g.log_abs for g in gs]), torch.cat([g.sign for g in gs]))


def _g_eye(batch, d: int, device) -> Goom:
    eye = torch.eye(d, dtype=torch.bool, device=device)
    log = torch.zeros(d, d, device=device).masked_fill(~eye, -torch.inf)
    return _g_expand(Goom(log, torch.ones(d, d, device=device)), tuple(batch) + (d, d))


def _pad_time(g: Goom, pad: int, fill: Goom) -> Goom:
    """``g`` followed by ``pad`` copies of the identity element ``fill``."""
    if pad == 0:
        return g
    return _g_cat([g, _g_expand(Goom(fill.log_abs[None], fill.sign[None]),
                                (pad,) + tuple(g.shape[1:]))])


def _shard(g: Goom, spec: ShardSpec) -> Goom:
    tl = g.shape[0] // spec.n_shards
    r = spec.index
    return g[r * tl:(r + 1) * tl]


def _carry_combine(lmme: Callable[[Goom, Goom], Goom]):
    """The (A, B) monoid, as tensors: core.scan's algebra."""

    def combine(e, l):
        a_e, b_e = Goom(e[0], e[1]), Goom(e[2], e[3])
        a_l, b_l = Goom(l[0], l[1]), Goom(l[2], l[3])
        a = lmme(a_l, a_e)
        b = goom_add(lmme(a_l, b_e), b_l)
        return a.log_abs, a.sign, b.log_abs, b.sign

    return combine


def _exclusive(p: Goom, first: Goom, idx: int) -> Goom:
    """The compound entering shard ``idx``: ``first`` (the identity) for
    shard 0, else the inclusive prefix of the shards before it.  Built alike
    on every rank (the identity put before the prefix, then indexed), so
    that every rank's autograd graph, and with it the order of the backward's
    collectives, is the same."""
    return Goom(torch.cat([first.log_abs[None], p.log_abs[:-1]])[idx],
                torch.cat([first.sign[None], p.sign[:-1]])[idx])


# ---------------------------------------------------------------------------
# matrix recurrence:  X_t = A_t X_{t-1} ⊕ B_t
# ---------------------------------------------------------------------------
def seq_sharded_matrix_scan(a: Goom, b: Goom, x0: Optional[Goom], *, spec: ShardSpec,
                            local_matrix_scan: Callable, local_cumulative_lmme: Callable,
                            lmme: Callable[[Goom, Goom], Goom]) -> Goom:
    """All states of the matrix recurrence, time-sharded over the seq group.

    a (T, ..., d, d), b (T, ..., d, m), x0 (..., d, m) or None, all
    full-length on every rank.  On each rank: one local with-B scan, one
    local zero-B scan and one ``lmme`` (the stitch); the P-carry scan runs
    on the plain LMME."""
    p = spec.n_shards
    t = b.shape[0]
    if t < p:
        return local_matrix_scan(a, b, x0)
    dev = b.log_abs.device
    d, m = a.shape[-1], b.shape[-1]
    batch = tuple(torch.broadcast_shapes(a.shape[1:-2], b.shape[1:-2]))
    a = _g_expand(_replicated(a, spec), (t,) + batch + (d, d))
    b = _g_expand(_replicated(b, spec), (t,) + batch + (d, m))
    x0g = None if x0 is None else _g_expand(_replicated(x0, spec), batch + (d, m))
    pad = (-t) % p
    a = _pad_time(a, pad, _g_eye(batch, d, dev))
    b = _pad_time(b, pad, goom_zeros(batch + (d, m), device=dev))
    out = matrix_scan_shard(_shard(a, spec), _shard(b, spec), x0g, spec=spec,
                            local_matrix_scan=local_matrix_scan,
                            local_cumulative_lmme=local_cumulative_lmme, lmme=lmme)
    return _unshard(out, spec, t)


def matrix_scan_shard(a_l: Goom, b_l: Goom, x0: Optional[Goom], *, spec: ShardSpec,
                      local_matrix_scan: Callable, local_cumulative_lmme: Callable,
                      lmme: Callable[[Goom, Goom], Goom]) -> Goom:
    """This rank's states from its time shard (``shard_map``'s body): a_l
    (T/P, ..., d, d) and b_l (T/P, ..., d, m) of equal batch dims, x0 (...,
    d, m) or None (zeros), the same on every rank of the group."""
    dev = b_l.log_abs.device
    d, m = a_l.shape[-1], b_l.shape[-1]
    batch = tuple(b_l.shape[1:-2])
    x0g = goom_zeros(batch + (d, m), device=dev) if x0 is None else x0
    states0 = local_matrix_scan(a_l, b_l, None)
    astar = local_cumulative_lmme(a_l)
    ga = _g_gather(astar[-1], spec, reduce=True)
    gb = _g_gather(states0[-1], spec, reduce=True)
    pa_l, pa_s, pb_l, pb_s = associative_scan(
        _carry_combine(lmme_reference), (ga.log_abs, ga.sign, gb.log_abs, gb.sign))
    idx = spec.index
    a_in = _exclusive(Goom(pa_l, pa_s), _g_eye(batch, d, dev), idx)
    b_in = _exclusive(Goom(pb_l, pb_s), goom_zeros(batch + (d, m), device=dev), idx)
    x_in = goom_add(lmme_reference(a_in, x0g), b_in)
    return goom_add(lmme(astar, x_in), states0)


# ---------------------------------------------------------------------------
# prefix products:  A_t ··· A_1   (paper eq. 24)
# ---------------------------------------------------------------------------
def seq_sharded_cumulative_lmme(a: Goom, *, spec: ShardSpec, local_cumulative_lmme: Callable,
                                lmme: Callable[[Goom, Goom], Goom]) -> Goom:
    """All prefix products, time-sharded: on each rank one local zero-B scan
    and one ``lmme`` (the stitch)."""
    p = spec.n_shards
    t = a.shape[0]
    if t < p:
        return local_cumulative_lmme(a)
    dev = a.log_abs.device
    d = a.shape[-1]
    batch = tuple(a.shape[1:-2])
    pad = (-t) % p
    a = _pad_time(_replicated(a, spec), pad, _g_eye(batch, d, dev))
    out = cumulative_lmme_shard(_shard(a, spec), spec=spec,
                                local_cumulative_lmme=local_cumulative_lmme, lmme=lmme)
    return _unshard(out, spec, t)


def cumulative_lmme_shard(a_l: Goom, *, spec: ShardSpec, local_cumulative_lmme: Callable,
                          lmme: Callable[[Goom, Goom], Goom]) -> Goom:
    """This rank's prefix products from its time shard a_l (T/P, ..., d, d)."""
    d = a_l.shape[-1]
    astar = local_cumulative_lmme(a_l)
    g = _g_gather(astar[-1], spec, reduce=True)

    def combine(e, l):
        out = lmme_reference(Goom(*l), Goom(*e))
        return out.log_abs, out.sign

    pref = Goom(*associative_scan(combine, (g.log_abs, g.sign)))
    p_in = _exclusive(pref, _g_eye(tuple(a_l.shape[1:-2]), d, a_l.log_abs.device),
                      spec.index)
    return lmme(astar, p_in)


# ---------------------------------------------------------------------------
# diagonal recurrence:  x_t = a_t ⊙ x_{t-1} ⊕ b_t
# ---------------------------------------------------------------------------
def seq_sharded_diagonal_scan(a: Goom, b: Goom, x0: Optional[Goom], *, spec: ShardSpec,
                              local_diagonal_scan: Callable) -> Goom:
    """The diagonal scan, time-sharded: on each rank one local diagonal scan;
    a shard's decay compound is a log-space cumsum, its stitch elementwise."""
    p = spec.n_shards
    t = b.shape[0] if b.log_abs.ndim else 1
    if t < p:
        return local_diagonal_scan(a, b, x0)
    dev = b.log_abs.device
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
    trail = shape[1:]
    a = _g_expand(_replicated(a, spec), shape)
    b = _g_expand(_replicated(b, spec), shape)
    x0g = None if x0 is None else _g_expand(_replicated(x0, spec), trail)
    pad = (-t) % p
    a = _pad_time(a, pad, goom_ones(trail, device=dev))
    b = _pad_time(b, pad, goom_zeros(trail, device=dev))
    out = diagonal_scan_shard(_shard(a, spec), _shard(b, spec), x0g, spec=spec,
                              local_diagonal_scan=local_diagonal_scan)
    return _unshard(out, spec, t)


def diagonal_scan_shard(a_l: Goom, b_l: Goom, x0: Optional[Goom], *, spec: ShardSpec,
                        local_diagonal_scan: Callable) -> Goom:
    """This rank's states from its time shard: a_l and b_l (T/P, ...) of one
    shape, x0 (...) or None (zeros), the same on every rank of the group."""
    dev = b_l.log_abs.device
    trail = tuple(b_l.shape[1:])
    x0g = goom_zeros(trail, device=dev) if x0 is None else x0
    states0 = local_diagonal_scan(a_l, b_l, None)
    astar = Goom(torch.cumsum(a_l.log_abs, 0), torch.cumprod(a_l.sign, 0))
    ga = _g_gather(astar[-1], spec, reduce=True)
    gb = _g_gather(states0[-1], spec, reduce=True)

    def combine(e, l):
        a_e, b_e = Goom(e[0], e[1]), Goom(e[2], e[3])
        a_l_, b_l_ = Goom(l[0], l[1]), Goom(l[2], l[3])
        a_o = goom_mul(a_l_, a_e)
        b_o = goom_add(goom_mul(a_l_, b_e), b_l_)
        return a_o.log_abs, a_o.sign, b_o.log_abs, b_o.sign

    pa_l, pa_s, pb_l, pb_s = associative_scan(
        combine, (ga.log_abs, ga.sign, gb.log_abs, gb.sign))
    idx = spec.index
    a_in = _exclusive(Goom(pa_l, pa_s), goom_ones(trail, device=dev), idx)
    b_in = _exclusive(Goom(pb_l, pb_s), goom_zeros(trail, device=dev), idx)
    x_in = goom_add(goom_mul(a_in, x0g), b_in)
    return goom_add(goom_mul(astar, _g_expand(x_in, astar.shape)), states0)


# ---------------------------------------------------------------------------
# DTensor operands: time shards in, time shards out (shard_map's semantics)
# ---------------------------------------------------------------------------
def _mapped(body: Callable, spec: ShardSpec, shards: Sequence[Goom],
            x0: Optional[Goom]) -> Goom:
    """``body(*shards, x0) -> Goom`` run by ``local_map`` on each rank's
    local tensors.  ``shards`` are Gooms of DTensors whose seq mesh dim is
    ``Shard(0)`` (time); ``x0`` is None or a Goom of DTensors replicated
    over the seq group, whose gradient is the sum over the group (every
    rank's stitch reads it).  The states come back placed as the last
    shard operand (JAX's ``t_spec`` in and out)."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    seq = spec.mesh.axis_names.index(spec.seq_axis)
    for g in shards:
        if g.log_abs.placements[seq] != Shard(0):
            raise ValueError(f"a sharded scan operand must be time-sharded over "
                             f"{spec.seq_axis!r}; got {g.log_abs.placements}")
    planes = [t for g in shards for t in (g.log_abs, g.sign)]
    n = len(planes)
    planes += [None, None] if x0 is None else [x0.log_abs, x0.sign]
    in_pl = tuple(None if t is None else tuple(t.placements) for t in planes)
    grad_pl = list(in_pl)
    if x0 is not None:
        grad_pl[n] = tuple(Partial() if i == seq else q for i, q in enumerate(in_pl[n]))

    def local(*ts):
        gs = [Goom(ts[i], ts[i + 1]) for i in range(0, n, 2)]
        x = None if ts[n] is None else Goom(ts[n], ts[n + 1])
        out = body(*gs, x)
        return out.log_abs, out.sign

    out_pl = in_pl[n - 2]
    log, sign = local_map(local, out_placements=(out_pl, out_pl), in_placements=in_pl,
                          in_grad_placements=tuple(grad_pl),
                          device_mesh=spec.mesh.device_mesh)(*planes)
    return Goom(log, sign)


def mapped_matrix_scan(a: Goom, b: Goom, x0: Optional[Goom], *, spec: ShardSpec,
                       **local_impls) -> Goom:
    """:func:`matrix_scan_shard` on time-sharded DTensor operands."""
    return _mapped(lambda a_l, b_l, x: matrix_scan_shard(a_l, b_l, x, spec=spec,
                                                         **local_impls),
                   spec, (a, b), x0)


def mapped_cumulative_lmme(a: Goom, *, spec: ShardSpec, **local_impls) -> Goom:
    """:func:`cumulative_lmme_shard` on a time-sharded DTensor operand."""
    return _mapped(lambda a_l, _x: cumulative_lmme_shard(a_l, spec=spec, **local_impls),
                   spec, (a,), None)


def mapped_diagonal_scan(a: Goom, b: Goom, x0: Optional[Goom], *, spec: ShardSpec,
                         **local_impls) -> Goom:
    """:func:`diagonal_scan_shard` on time-sharded DTensor operands."""
    return _mapped(lambda a_l, b_l, x: diagonal_scan_shard(a_l, b_l, x, spec=spec,
                                                           **local_impls),
                   spec, (a, b), x0)


# ---------------------------------------------------------------------------
# generic associative scan (the selective-reset scan rides it)
# ---------------------------------------------------------------------------
def seq_sharded_associative_scan(fn, elems, *, spec: ShardSpec):
    """``core.scan.associative_scan(fn, elems)``, time-sharded.

    ``elems`` is a tuple of tensors with a leading time axis and ``fn`` any
    associative combine over such tuples (the selective-reset monoid
    included).  An arbitrary monoid has no identity to pad with, so T must
    be a multiple of the shard count, and shard 0 keeps its local scan
    where the others combine with the prefix before them (``fn`` runs on
    every rank all the same, as in JAX)."""
    elems = tuple(_SumGrad.apply(x, spec) if x.requires_grad else x for x in elems)
    t = elems[0].shape[0]
    p = spec.n_shards
    if t % p != 0:
        raise ValueError(f"sharded associative scan needs T % n_shards == 0, got "
                         f"T={t}, n_shards={p} (generic monoid: no identity to pad with)")
    tl = t // p
    idx = spec.index
    local = tuple(associative_scan(fn, tuple(x[idx * tl:(idx + 1) * tl] for x in elems)))
    gathered = tuple(_gather(x[-1], spec, reduce=True) for x in local)
    pref = associative_scan(fn, gathered)
    prev = tuple(x[max(idx - 1, 0)] for x in pref)
    stitched = tuple(fn(tuple(x.expand((tl,) + tuple(x.shape)) for x in prev), local))
    first = torch.tensor(idx == 0, device=elems[0].device)
    out = tuple(torch.where(first, l, s) for l, s in zip(local, stitched))
    return tuple(_gather(x, spec).flatten(0, 1) for x in out)
