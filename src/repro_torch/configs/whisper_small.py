"""whisper-small [audio] — 12L (+12L enc) d=768 12H ff=3072 vocab=51865.
Encoder-decoder with learned positions; the conv frontend is a stub
(``input_specs`` gives precomputed frame embeddings).  [arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import AttentionConfig
from repro_torch.core.distr_attention import DistrConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="encdec",
        attn_shard="seq",
        n_layers=12,
        n_encoder_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab=51865,
        head_dim=64,
        act="gelu",
        norm="layernorm",
        pos="learned",
        learned_pos_len=32768,
        frontend="audio_stub",
        cross_len=1500,
        attention=AttentionConfig(
            impl="distr",
            distr=DistrConfig(group_size=2, block_q=128),
        ),
    )


def reduced() -> ModelConfig:
    return config().replace(
        compute_dtype="float32", capacity_factor=4.0,
        n_layers=2, n_encoder_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=512, learned_pos_len=512, cross_len=64,
        attention=AttentionConfig(impl="distr", distr=DistrConfig(group_size=2, block_q=32)),
    )
