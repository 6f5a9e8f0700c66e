"""llama4-scout-17b-a16e [moe] — 48L d=5120 40H (GQA kv=8) vocab=202048,
MoE 16 experts top-1 + 1 shared expert (d_ff_expert=8192).
Early fusion is multimodal-specific; the assigned shapes are text-only so the
backbone here is the text LM.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import AttentionConfig
from repro_torch.core.distr_attention import DistrConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        attn_shard="seq",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab=202048,
        head_dim=128,
        n_experts=16,
        moe_top_k=1,
        n_shared_experts=1,
        d_ff_expert=8192,
        attention=AttentionConfig(
            impl="distr",
            distr=DistrConfig(group_size=2, block_q=128),
        ),
    )


def reduced() -> ModelConfig:
    return config().replace(
        compute_dtype="float32", capacity_factor=4.0,
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, n_experts=4, moe_top_k=1, n_shared_experts=1,
        d_ff_expert=128,
        attention=AttentionConfig(impl="distr", distr=DistrConfig(group_size=2, block_q=32)),
    )
