"""internvl2-2b [vlm] — 24L d=2048 16H (GQA kv=8) ff=8192 vocab=92553.
The InternViT frontend is a stub (``input_specs`` gives precomputed patch
embeddings, a prefix of the decoder's input); InternLM2 LM backbone.
[arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import AttentionConfig
from repro_torch.core.distr_attention import DistrConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="dense",
        attn_shard="seq",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab=92553,
        head_dim=128,
        frontend="patch_stub",
        num_patch_tokens=256,
        attention=AttentionConfig(
            impl="distr",
            distr=DistrConfig(group_size=2, block_q=128),
        ),
    )


def reduced() -> ModelConfig:
    return config().replace(
        compute_dtype="float32", capacity_factor=4.0,
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, num_patch_tokens=16,
        attention=AttentionConfig(impl="distr", distr=DistrConfig(group_size=2, block_q=32)),
    )
