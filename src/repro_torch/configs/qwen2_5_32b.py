"""qwen2.5-32b [dense] — 64L d=5120 40H (GQA kv=8) ff=27648 vocab=152064.
GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B family scaling; hf]
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import AttentionConfig
from repro_torch.core.distr_attention import DistrConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        attn_shard="seq",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=27648,
        vocab=152064,
        head_dim=128,
        qkv_bias=True,
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
