"""deepseek-v2-236b [moe] — 60L d=5120 128H MLA (kv_lora=512) vocab=102400,
MoE: 2 shared + 160 routed top-6 (d_ff_expert=1536), first layer dense
(d_ff=12288).  [arXiv:2405.04434; hf]

DistrAttention applies to the materialised per-head QKᵀ over the nope
sub-dimension; RoPE dims stay exact.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import AttentionConfig
from repro_torch.core.distr_attention import DistrConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        attn_shard="heads",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,  # the single dense layer
        vocab=102400,
        n_experts=160,
        moe_top_k=6,
        n_shared_experts=2,
        d_ff_expert=1536,
        first_dense_layers=1,
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        attention=AttentionConfig(
            impl="distr",
            distr=DistrConfig(group_size=2, block_q=128),
        ),
    )


def reduced() -> ModelConfig:
    return config().replace(
        compute_dtype="float32", capacity_factor=4.0,
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
        n_experts=8, moe_top_k=2, n_shared_experts=1, d_ff_expert=64,
        first_dense_layers=1, q_lora_rank=64, kv_lora_rank=32,
        qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
        attention=AttentionConfig(impl="distr", distr=DistrConfig(group_size=2, block_q=32)),
    )
