"""The goom-rnn decoder: GOOM SSM layer, blocks, and the DecoderLM."""

from .blocks import Block, block_init_cache
from .goom_layer import GoomSSM, goom_ssm_init_state
from .model import DecoderLM

__all__ = ["Block", "block_init_cache", "GoomSSM", "goom_ssm_init_state",
           "DecoderLM"]
