"""Distributed runtime: ring sequence-parallel (context-parallel)
attention over ``torch.distributed``."""
from repro_torch.distributed import ring_attention

__all__ = ["ring_attention"]
