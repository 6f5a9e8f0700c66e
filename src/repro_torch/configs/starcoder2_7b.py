"""starcoder2-7b [dense] — 32L d=4608 36H (GQA kv=4) ff=18432 vocab=49152.
GQA + RoPE; layernorm/gelu trunk with QKV bias.  [arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import AttentionConfig
from repro_torch.core.distr_attention import DistrConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        attn_shard="seq",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        d_ff=18432,
        vocab=49152,
        head_dim=128,
        qkv_bias=True,
        act="gelu",
        norm="layernorm",
        rope_theta=1e6,
        attention=AttentionConfig(
            impl="distr",
            distr=DistrConfig(group_size=2, block_q=128),
        ),
    )


def reduced() -> ModelConfig:
    return config().replace(
        compute_dtype="float32", capacity_factor=4.0,
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512,
        attention=AttentionConfig(impl="distr", distr=DistrConfig(group_size=2, block_q=32)),
    )
