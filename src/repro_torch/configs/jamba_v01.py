"""Jamba-v0.1 52B [arXiv:2403.19887]: 32L, d=4096, Mamba+attention 1:7
interleave (attention at offset 4 of each 8-layer period), MoE 16 experts
top-2 every other layer (offset 1), 32H GQA kv=8, d_ff=14336, vocab=65536.
Same numbers as the JAX package's ``repro/configs/jamba_v01.py``, RoPE on
the attention layers included."""

from .base import BlockCfg, GroupCfg, LMConfig, MambaCfg, MlpCfg, MoeCfg, attn_block


def _make(d, layers, heads, kv, ff, vocab, n_exp, name, d_state=16, chunk=64,
          scan_impl="goom"):
    mamba = MambaCfg(d_model=d, d_state=d_state, chunk=chunk, scan_impl=scan_impl)
    moe = MoeCfg(d_model=d, d_ff=ff, n_experts=n_exp, top_k=2)
    mlp = MlpCfg(d_model=d, d_ff=ff)

    def layer(idx: int) -> BlockCfg:
        channel = "moe" if idx % 2 == 1 else "mlp"
        if idx % 8 == 4:
            return attn_block(d, heads, kv, ff, rope_theta=10000.0,
                              moe=moe if channel == "moe" else None)
        return BlockCfg(mixer="mamba", channel=channel, mamba=mamba,
                        moe=moe if channel == "moe" else None,
                        mlp=mlp if channel == "mlp" else None)

    assert layers % 8 == 0
    return LMConfig(
        name=name, family="hybrid", vocab=vocab, d_model=d, n_layers=layers,
        groups=(GroupCfg(period=tuple(layer(i) for i in range(8)),
                         n_periods=layers // 8),),
        sub_quadratic=True,
    )


def config() -> LMConfig:
    return _make(4096, 32, 32, 8, 14336, 65536, 16, "jamba-v0.1")


def smoke_config() -> LMConfig:
    return _make(64, 8, 4, 2, 128, 256, 4, "jamba-v0.1-smoke", d_state=4, chunk=8)
