"""qwen1.5-4b [dense] — 40L d=2560 20H (kv=20) ff=6912 vocab=151936.
MHA with QKV bias.  [hf:Qwen/Qwen1.5-0.5B family scaling; hf]
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import AttentionConfig
from repro_torch.core.distr_attention import DistrConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        attn_shard="seq",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        d_ff=6912,
        vocab=151936,
        head_dim=128,
        qkv_bias=True,
        attention=AttentionConfig(
            impl="distr",
            distr=DistrConfig(group_size=2, block_q=128),
        ),
    )


def reduced() -> ModelConfig:
    return config().replace(
        compute_dtype="float32", capacity_factor=4.0,
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512,
        attention=AttentionConfig(impl="distr", distr=DistrConfig(group_size=2, block_q=32)),
    )
