"""Serving: continuous-batching engine, dense slot state cache, chunked prefill."""

from .prefill import ChunkedPrefill
from .scheduler import Engine, Request
from .state_cache import SlotAllocator, merge_frozen, read_slot, write_slot

__all__ = ["ChunkedPrefill", "Engine", "Request", "SlotAllocator",
           "merge_frozen", "read_slot", "write_slot"]
