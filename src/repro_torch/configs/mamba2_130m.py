"""mamba2-130m [ssm] — 24L d=768 (attention-free) vocab=50280, ssm_state=128.
SSD (state-space duality); DistrAttention is inapplicable (no QKᵀ stage).
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import AttentionConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=12,  # unused (attention-free)
        n_kv_heads=12,
        d_ff=0,
        vocab=50280,
        tie_embeddings=True,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_groups=1,
        ssm_chunk=128,
        attention=AttentionConfig(impl="reference"),
    )


def reduced() -> ModelConfig:
    return config().replace(
        compute_dtype="float32", capacity_factor=4.0,
        n_layers=2, d_model=128, vocab=512, ssm_state=16, ssm_head_dim=32,
        ssm_chunk=32,
    )
