"""Model configuration: the dense, MoE (with MLA), SSM, hybrid and enc-dec
subset of ``repro.configs.base``.

One ``ModelConfig`` per architecture; ``configs/<arch>.py`` holds the
published dimensions plus a ``reduced()`` variant for CPU tests.  Only the
fields the port's serving and training paths read are carried over.
``SHAPES`` are the reference's named workload shapes, which
``roofline.analysis.model_flops`` reads; ``input_specs`` gives a shape's
model inputs, the stub frontends' embeddings among them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from repro_torch.core.api import AttentionConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    # dense | moe | ssm (attention-free Mamba-2) | hybrid (Mamba-2 + shared
    # attention) | encdec (an encoder over frames, a decoder with cross-attention)
    family: str
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
    pos: str = "rope"  # rope (on every self-attention) | learned (``pos_embed``) | none
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    compute_dtype: str = "bfloat16"  # activations and caches; serving's weights
    # distribution (distributed.sharding): "seq" asks the reference's GSPMD to
    # shard attention's sequence over "model" when the heads do not divide it;
    # the port's tensor parallelism runs attention on local heads either way
    attn_shard: str = "heads"  # heads | seq
    fsdp: bool = True  # shard params and AdamW moments over the data axis too
    # training
    param_dtype: str = "float32"  # master weights (AdamW moments are f32)
    remat: str = "full"  # full (recompute each block in the backward) | none
    schedule: str = "cosine"  # cosine | wsd
    # MoE (models.moe)
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0  # leading layers with a dense FFN (``dense_blocks``)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_impl: str = "auto"  # auto | dense_onehot | ep_a2a | ep_psum
    # MLA (deepseek): low-rank Q, compressed KV cache, decoupled RoPE
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # SSM / hybrid (Mamba-2 blocks)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0  # hybrid: a shared attention block after every k Mamba layers
    n_shared_attn_blocks: int = 2
    # Enc-dec and the stub frontends: precomputed frame (audio_stub, the
    # encoder's input) or patch (patch_stub, a prefix of the decoder's input)
    # embeddings of width d_model
    n_encoder_layers: int = 0  # 0 → n_layers
    frontend: str | None = None  # audio_stub | patch_stub
    num_patch_tokens: int = 256  # patch_stub: image tokens a sample
    cross_len: int = 1500  # the encoder output a decode step's cross cache holds
    learned_pos_len: int = 32768  # rows of ``pos_embed`` when pos == "learned"

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256; the pad logits are masked to -1e30."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def qk_head_dim(self) -> int:
        if self.use_mla:
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim_

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- shape applicability --------------------------------------------
    def supports_shape(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k":
            # needs sub-quadratic sequence handling
            return self.family in ("ssm", "hybrid")
        return True

    def skip_reason(self, shape: ShapeSpec) -> str | None:
        if self.supports_shape(shape):
            return None
        return (
            "long_500k requires sub-quadratic attention; "
            f"{self.name} is a pure softmax-attention arch (see DESIGN.md §4)"
        )


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The model inputs of ``shape`` as ``(shape, dtype)`` pairs, with the
    reference's keys, shapes and dtypes (``repro.configs.base.input_specs``).

    train → tokens and labels (+ the stub frontend's embeddings); prefill →
    tokens (+ embeddings); decode → one token a row (the serve layer adds
    the cache).  Enc-dec takes ``frames`` (B, S, d_model) beside S tokens; a
    patch_stub config ``patches`` (B, P, d_model) with P = min(
    num_patch_tokens, S // 2) and S − P tokens.  Tokens and labels are
    int32, the embeddings bf16 (the reference names that dtype ``f32``)."""
    b, s = shape.global_batch, shape.seq_len

    def tok(n):
        return ((b, n), torch.int32)

    def emb(n):
        return ((b, n, cfg.d_model), torch.bfloat16)

    if shape.kind == "decode":
        return {"tokens": tok(1)}  # the serve layer adds the cache
    if cfg.family == "encdec":
        specs = {"frames": emb(s), "tokens": tok(s)}
        n_text = s
    elif cfg.frontend == "patch_stub":
        n_patch = min(cfg.num_patch_tokens, s // 2)
        specs = {"patches": emb(n_patch), "tokens": tok(s - n_patch)}
        n_text = s - n_patch
    else:
        specs = {"tokens": tok(s)}
        n_text = s
    if shape.kind == "train":
        specs["labels"] = tok(n_text)
    return specs
