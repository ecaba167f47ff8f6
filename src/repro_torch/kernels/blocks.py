"""Per-(op, backend) block configurations of the port's engine ops.

The port's copy of ``repro/kernels/blocks.py`` (plain Python, nothing of the
JAX package imported).  One :class:`BlockConfig` names every launch knob an
implementation takes; each (op, backend) reads the fields that mean
something to it:

  ================  ===============  =========================================
  op                backend          fields
  ================  ===============  =========================================
  matrix_scan       cuda             ``block_t``: the with-B kernel's time
                                     chunk L (None: ``with_b_chunk_len``);
                                     ``algo="seq"``: L = T, the one-chunk walk
  cumulative_lmme   cuda             ``block_t``: the zero-B kernel's time
                                     chunk L (None: ``zero_b_chunk_len``);
                                     ``algo="seq"``: L = T, one chunk
  lmme              cuda             none: the kernel's tiles are constexpr
  diagonal_scan     cuda             none: one thread a channel walks time
  matrix_scan       torch_reference  ``block_t``: the time chunk of the
                                     chunked associative scan (default 128,
                                     JAX's ``_matrix_ref_chunked``)
  others            torch_reference  none
  ================  ===============  =========================================

The defaults give every launch the L it took before the registry existed, so
a run with no override and no autotune cache entry launches exactly as
before.  Resolution order (``core/engine.py``): ``engine.use_blocks()``
overrides, then the autotune cache (``kernels/autotune.py``), then
:data:`DEFAULTS`.  Nothing outside ``kernels/`` names a block size.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["BlockConfig", "DEFAULTS", "default_blocks", "merge", "shape_bucket", "OPS"]

OPS = ("lmme", "diagonal_scan", "matrix_scan", "cumulative_lmme")


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Launch knobs for one (op, backend) pair.  ``None`` = unused by that
    implementation (or "inherit the default" when merging).  The fields are
    JAX's; the port's implementations read ``block_t`` and ``algo`` only
    (the other tiles are constexpr in its kernels)."""

    block_t: Optional[int] = None   # scans: time chunk
    block_c: Optional[int] = None   # diagonal scan: channel tile
    block_n: Optional[int] = None   # lmme: output-row tile
    block_m: Optional[int] = None   # lmme: output-col tile
    block_d: Optional[int] = None   # lmme: contraction tile
    num_warps: Optional[int] = None
    num_stages: Optional[int] = None
    algo: Optional[str] = None      # cuda scans: "seq" (L = T) | "chunked"

    def to_dict(self) -> Dict[str, object]:
        """The non-None fields, for JSON persistence and repr."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}


def merge(base: BlockConfig, override: BlockConfig) -> BlockConfig:
    """``override``'s non-None fields win over ``base``."""
    return dataclasses.replace(base, **override.to_dict())


_REF_MAT = BlockConfig(block_t=128)   # JAX's xla_reference chunk (blocks.py _REF_MAT)

DEFAULTS: Dict[Tuple[str, str], BlockConfig] = {}
for _op in OPS:
    DEFAULTS[(_op, "cuda")] = BlockConfig()
    DEFAULTS[(_op, "torch_reference")] = (
        _REF_MAT if _op in ("matrix_scan", "cumulative_lmme") else BlockConfig())


def default_blocks(op: str, backend: str) -> BlockConfig:
    try:
        return DEFAULTS[(op, backend)]
    except KeyError:
        raise KeyError(f"no default BlockConfig for op {op!r} on backend "
                       f"{backend!r}") from None


def _pow2_ceil(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def shape_bucket(dims: Tuple[int, ...]) -> Tuple[int, ...]:
    """Each problem dim rounded up to a power of two: nearby shapes share one
    autotuned winner.  The bucket is part of the autotune cache key."""
    return tuple(_pow2_ceil(d) for d in dims)
