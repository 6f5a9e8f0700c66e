"""zamba2-7b [hybrid] — 81L d=3584 32H ff=14336 vocab=32000, ssm_state=64.
Mamba2 backbone with 2 alternating SHARED attention blocks applied after
every 6th mamba layer (concat-skip from the embedding trunk).
[arXiv:2411.15242; unverified]
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import AttentionConfig
from repro_torch.core.distr_attention import DistrConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        attn_shard="heads",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab=32000,
        head_dim=112,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_groups=1,
        ssm_chunk=128,
        attn_every=6,
        n_shared_attn_blocks=2,
        attention=AttentionConfig(
            impl="distr",
            distr=DistrConfig(group_size=2, block_q=128),
        ),
    )


def reduced() -> ModelConfig:
    return config().replace(
        compute_dtype="float32", capacity_factor=4.0,
        n_layers=5, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512, ssm_state=16, ssm_head_dim=32, ssm_chunk=32,
        attn_every=2, n_shared_attn_blocks=2,
        attention=AttentionConfig(impl="distr", distr=DistrConfig(group_size=2, block_q=32)),
    )
