"""MusicGen-large backbone [arXiv:2306.05284]: 48L decoder-only over EnCodec
tokens, d=2048, 32H MHA, d_ff=8192 (GELU, non-gated), vocab=2048,
sinusoidal positions, LayerNorm; no rotary embedding.

The EnCodec/text frontend is a stub, as in the JAX package: ``prefix_embeds``
carries precomputed conditioning frame embeddings.  Same numbers as
``repro/configs/musicgen_large.py``."""

from .base import LMConfig, attn_block, uniform_groups


def _make(d, layers, heads, ff, vocab, n_prefix, name):
    blk = attn_block(d, heads, heads, ff, rotary_fraction=0.0,  # no RoPE
                     activation="gelu", gated=False, norm="ln")
    return LMConfig(
        name=name, family="audio", vocab=vocab, d_model=d, n_layers=layers,
        groups=uniform_groups(blk, layers),
        final_norm="ln", pos_embedding="sinusoidal",
        frontend="audio", n_prefix=n_prefix,
        sub_quadratic=False,
    )


def config() -> LMConfig:
    return _make(2048, 48, 32, 8192, 2048, 64, "musicgen-large")


def smoke_config() -> LMConfig:
    return _make(64, 2, 4, 128, 64, 4, "musicgen-large-smoke")
