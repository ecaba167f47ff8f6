"""Serving: continuous-batching engine, paged slot state cache, chunked
prefill, CUDA-graph steps and the HTTP front door (``serve.api``).

Exports what ``repro.serve`` exports, less ``abstract_caches`` and
``abstract_slot_caches`` (``jax.eval_shape`` tools: ``slot_cache_bytes``
sizes a config from ``device="meta"`` tensors instead).
"""

from .graphs import StepGraphs
from .metrics import ServeMetrics
from .prefill import ChunkedPrefill
from .scheduler import CANCELLED, Engine, Request
from .state_cache import (
    PagePool,
    PrefixIndex,
    SlotAllocator,
    gather_prefix,
    merge_frozen,
    read_slot,
    slot_cache_bytes,
    strip_checkpoint,
    write_slot,
    write_slot_paged,
)
from .steps import (
    generate,
    make_decode_in_place,
    make_decode_multi,
    make_decode_step,
    make_prefill_step,
)

__all__ = [
    "CANCELLED",
    "Engine",
    "Request",
    "ServeMetrics",
    "ChunkedPrefill",
    "StepGraphs",
    "PagePool",
    "PrefixIndex",
    "SlotAllocator",
    "slot_cache_bytes",
    "gather_prefix",
    "merge_frozen",
    "read_slot",
    "strip_checkpoint",
    "write_slot",
    "write_slot_paged",
    "generate",
    "make_prefill_step",
    "make_decode_step",
    "make_decode_multi",
    "make_decode_in_place",
]
