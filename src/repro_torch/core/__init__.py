"""DistrAttention core — the paper's contribution as PyTorch functions."""
from repro_torch.core.api import IMPLS, AttentionConfig, attend, attend_decode
from repro_torch.core.distr_attention import DistrConfig, distr_attention, distr_scores
from repro_torch.core.flash_reference import blockwise_flash_reference, reference_attention
from repro_torch.core import grouping, lsh

__all__ = [
    "IMPLS",
    "AttentionConfig",
    "DistrConfig",
    "attend",
    "attend_decode",
    "blockwise_flash_reference",
    "distr_attention",
    "distr_scores",
    "grouping",
    "lsh",
    "reference_attention",
]
