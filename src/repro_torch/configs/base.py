"""Model configuration: the dense-decoder subset of ``repro.configs.base``.

One ``ModelConfig`` per architecture; ``configs/<arch>.py`` holds the
published dimensions plus a ``reduced()`` variant for CPU tests.  Only the
fields the dense slot-engine and training paths read are carried over.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch.core.api import AttentionConfig


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense (the only family this port serves so far)
    # transformer trunk
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False  # the LM head reads the embedding table
    act: str = "silu"  # silu (SwiGLU) | gelu (tanh approximation)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10000.0  # RoPE on every layer
    norm_eps: float = 1e-6
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    compute_dtype: str = "bfloat16"  # activations and caches; serving's weights
    # training
    param_dtype: str = "float32"  # master weights (AdamW moments are f32)
    remat: str = "full"  # full (recompute each block in the backward) | none
    schedule: str = "cosine"  # cosine | wsd

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256; the pad logits are masked to -1e30."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
