"""The per-value abstract lattice of the graph layer.

The port's copy of ``repro/analysis/lattice.py``.  Each tensor the walker
sees carries an :class:`AbsVal`:

  * ``domain``: what the bits *mean*:
      - ``"log"``     a log-space magnitude (a GOOM ``log_abs`` plane, or
                      anything derived from one or from a log op);
      - ``"sign"``    a GOOM sign plane ({+1, -1});
      - ``"linear"``  an ordinary real value;
      - ``"unknown"`` ints, bools, fresh constants.
  * ``rescaled``: for log values, a dominating max has been subtracted
      (``x - max(x).detach()`` <= 0), so ``exp`` is bounded by 1.  GOOMs
      remove *overflow* only when every exit from log space is
      max-rescaled.
  * ``from_log``: for linear values, produced by ``exp`` of an *unrescaled*
      log magnitude (an overflow waiting to happen; reductions over such
      values also bypass the LSE/LMME monoid: rule GC104).
  * ``origin``: seed tokens of the log magnitudes this value descends from;
      ``max_of``: origins this value is a running maximum over.
      ``sub(x, m)`` with ``m.max_of`` meeting ``x.origin`` is what turns
      ``rescaled`` on.

The join serves ``where`` and every op without a rule of its own.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Iterable, List, Optional, Tuple

import torch

__all__ = ["AbsVal", "TokenSource", "UNKNOWN", "join", "seed_from_spec",
           "seed_tree"]

_DOMAIN_ORDER = ("log", "linear", "sign", "unknown")


@dataclasses.dataclass(frozen=True)
class AbsVal:
    domain: str = "unknown"
    rescaled: bool = False
    from_log: bool = False
    origin: FrozenSet[int] = frozenset()
    max_of: FrozenSet[int] = frozenset()


UNKNOWN = AbsVal()
LINEAR = AbsVal(domain="linear")


def join(vals: Iterable[AbsVal]) -> AbsVal:
    """Merge abstract values (``where``, elementwise ops).

    Domain joins toward the most load-bearing interpretation (log wins: a
    value that *might* be a log magnitude must be treated as one);
    ``rescaled`` requires every log contributor to be rescaled (adding an
    unrescaled log back in undoes the domination); ``from_log`` is sticky.
    """
    vals = list(vals)
    if not vals:
        return UNKNOWN
    if len(vals) == 1:
        return vals[0]
    domain = "unknown"
    for d in _DOMAIN_ORDER:
        if any(v.domain == d for v in vals):
            domain = d
            break
    return AbsVal(
        domain=domain,
        rescaled=all(v.rescaled for v in vals if v.domain == "log")
        and any(v.domain == "log" and v.rescaled for v in vals),
        from_log=any(v.from_log for v in vals),
        origin=frozenset().union(*(v.origin for v in vals)),
        max_of=frozenset().union(*(v.max_of for v in vals)),
    )


class TokenSource:
    """Fresh origin tokens for seeds and freshly created log magnitudes."""

    def __init__(self):
        self._next = 0

    def fresh(self) -> int:
        self._next += 1
        return self._next


def seed_from_spec(spec: str, tokens: TokenSource) -> AbsVal:
    """AbsVal for an explicit domain name ("log" gets a fresh origin)."""
    if spec == "log":
        return AbsVal(domain="log", origin=frozenset({tokens.fresh()}))
    if spec in ("linear", "sign", "unknown"):
        return AbsVal(domain=spec)
    raise ValueError(f"unknown domain spec {spec!r}")


def seed_tree(tree, tokens: TokenSource) -> List[Tuple[torch.Tensor, AbsVal]]:
    """``(tensor, AbsVal)`` for each tensor in a target's arguments.

    Domains come from, in priority order: an enclosing ``Goom`` (its
    ``_goomcheck_domains`` class tag names each dataclass field), a dict
    key naming convention (``*log*`` -> log, ``*sign*`` -> sign: the
    serve and model state dicts carry GOOM planes under ``"x_log"`` /
    ``"x_sign"`` keys), else dtype (floats are linear).
    """
    out: List[Tuple[torch.Tensor, AbsVal]] = []

    def rec(x, forced: Optional[str] = None):
        domains = getattr(type(x), "_goomcheck_domains", None)
        if domains is not None:      # a Goom (or any tagged dataclass)
            for field, dom in zip(dataclasses.fields(x), domains):
                rec(getattr(x, field.name), dom)
            return
        if isinstance(x, torch.Tensor):
            if forced is not None:
                out.append((x, seed_from_spec(forced, tokens)))
            elif x.dtype.is_floating_point:
                out.append((x, LINEAR))
            else:
                out.append((x, UNKNOWN))
            return
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                kf = forced
                if isinstance(k, str):
                    if "log" in k:
                        kf = "log"
                    elif "sign" in k:
                        kf = "sign"
                rec(x[k], kf)
            return
        if isinstance(x, (list, tuple)):
            for c in x:
                rec(c, forced)

    rec(tree)
    return out
