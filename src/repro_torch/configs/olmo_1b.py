"""OLMo-1B [arXiv:2402.00838]: 16L, d=2048, 16H MHA, d_ff=8192,
vocab=50304, non-parametric LayerNorm, tied embeddings.  Same numbers as
the JAX package's ``repro/configs/olmo_1b.py``."""

from .base import LMConfig, attn_block, uniform_groups


def _make(d, layers, heads, ff, vocab, name):
    blk = attn_block(d, heads, heads, ff, rope_theta=10000.0,
                     norm="ln_nonparam")
    return LMConfig(
        name=name, family="dense", vocab=vocab, d_model=d, n_layers=layers,
        groups=uniform_groups(blk, layers),
        tie_embeddings=True, final_norm="ln_nonparam",
        sub_quadratic=False,
    )


def config() -> LMConfig:
    return _make(2048, 16, 16, 8192, 50304, "olmo-1b")


def smoke_config() -> LMConfig:
    return _make(64, 2, 4, 128, 256, "olmo-1b-smoke")
