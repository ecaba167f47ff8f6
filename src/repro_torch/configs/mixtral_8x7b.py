"""Mixtral 8x7B [arXiv:2401.04088]: 32L, d=4096, 32H GQA kv=8, d_ff=14336,
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096): every
layer keeps a rolling buffer of the window's KV.  Same numbers as the JAX
package's ``repro/configs/mixtral_8x7b.py``."""

from .base import LMConfig, MoeCfg, attn_block, uniform_groups


def _make(d, layers, heads, kv, ff, vocab, n_exp, window, name):
    moe = MoeCfg(d_model=d, d_ff=ff, n_experts=n_exp, top_k=2)
    blk = attn_block(
        d, heads, kv, ff, rope_theta=1_000_000.0, window=window, moe=moe,
    )
    return LMConfig(
        name=name, family="moe", vocab=vocab, d_model=d, n_layers=layers,
        groups=uniform_groups(blk, layers),
        sub_quadratic=True,  # SWA: rolling-buffer cache, O(window) per token
    )


def config() -> LMConfig:
    return _make(4096, 32, 32, 8, 14336, 32000, 8, 4096, "mixtral-8x7b")


def smoke_config() -> LMConfig:
    return _make(64, 2, 4, 2, 128, 256, 4, 32, "mixtral-8x7b-smoke")
