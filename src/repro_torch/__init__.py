"""PyTorch and CUDA port of the GOOM system, for NVIDIA Hopper.

The JAX package ``repro`` is the reference it is held to; this package
imports nothing of it.  Entry points (``DecoderLM``, ``Engine``, the
``engine`` ops) run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .configs import get_config
from .convert import params_from_jax
from .core import Goom, engine, from_goom, to_goom
from .models import DecoderLM
from .serve import CANCELLED, ChunkedPrefill, Engine, Request

__all__ = ["get_config", "params_from_jax", "Goom", "engine", "from_goom",
           "to_goom", "DecoderLM", "CANCELLED", "ChunkedPrefill", "Engine", "Request"]
