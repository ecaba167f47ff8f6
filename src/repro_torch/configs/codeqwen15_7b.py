"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: 32L, d=4096, 32H MHA (kv=32),
d_ff=13440, vocab=92416, qkv bias, rope theta 1e6 (64k context).  Same
numbers as the JAX package's ``repro/configs/codeqwen15_7b.py``."""

from .base import LMConfig, attn_block, uniform_groups


def _make(d, layers, heads, ff, vocab, name):
    blk = attn_block(d, heads, heads, ff, rope_theta=1_000_000.0, qkv_bias=True)
    return LMConfig(
        name=name, family="dense", vocab=vocab, d_model=d, n_layers=layers,
        groups=uniform_groups(blk, layers),
        sub_quadratic=False,
    )


def config() -> LMConfig:
    return _make(4096, 32, 32, 13440, 92416, "codeqwen1.5-7b")


def smoke_config() -> LMConfig:
    return _make(64, 2, 4, 128, 256, "codeqwen1.5-7b-smoke")
