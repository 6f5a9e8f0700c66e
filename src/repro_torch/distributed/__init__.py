"""Distributed runtime over ``torch.distributed``: the sharding rules,
explicit collectives, the GPipe pipeline, and ring sequence-parallel
(context-parallel) attention."""
from repro_torch.distributed import collectives, pipeline, ring_attention, sharding

__all__ = ["collectives", "pipeline", "ring_attention", "sharding"]
