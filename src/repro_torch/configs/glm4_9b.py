"""GLM-4-9B [hf:THUDM/glm-4-9b]: 40L, d=4096, 32H GQA kv=2, d_ff=13696,
vocab=151552, partial rotary (0.5), qkv bias.  Same numbers as the JAX
package's ``repro/configs/glm4_9b.py``."""

from .base import LMConfig, attn_block, uniform_groups


def _make(d, layers, heads, kv, ff, vocab, name):
    blk = attn_block(d, heads, kv, ff, rope_theta=10000.0,
                     rotary_fraction=0.5, qkv_bias=True)
    return LMConfig(
        name=name, family="dense", vocab=vocab, d_model=d, n_layers=layers,
        groups=uniform_groups(blk, layers),
        sub_quadratic=False,
    )


def config() -> LMConfig:
    return _make(4096, 40, 32, 2, 13696, 151552, "glm4-9b")


def smoke_config() -> LMConfig:
    return _make(64, 2, 4, 2, 128, 256, "glm4-9b-smoke")
