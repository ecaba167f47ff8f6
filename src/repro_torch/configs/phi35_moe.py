"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]:
32L, d=4096, 32H GQA kv=8, d_ff=6400, vocab=32064, MoE 16 experts top-2.
Same numbers as the JAX package's ``repro/configs/phi35_moe.py``."""

from .base import LMConfig, MoeCfg, attn_block, uniform_groups


def _make(d, layers, heads, kv, ff, vocab, n_exp, name):
    moe = MoeCfg(d_model=d, d_ff=ff, n_experts=n_exp, top_k=2)
    blk = attn_block(d, heads, kv, ff, rope_theta=10000.0, moe=moe)
    return LMConfig(
        name=name, family="moe", vocab=vocab, d_model=d, n_layers=layers,
        groups=uniform_groups(blk, layers),
        sub_quadratic=False,
    )


def config() -> LMConfig:
    return _make(4096, 32, 32, 8, 6400, 32064, 16, "phi3.5-moe")


def smoke_config() -> LMConfig:
    return _make(64, 2, 4, 2, 96, 256, 4, "phi3.5-moe-smoke")
