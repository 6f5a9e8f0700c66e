"""Serving: ring KV cache and slot engine; block-pool KV, continuous-batching
scheduler and paged engine; steps, sampler, lifecycle, degradation dial,
fault injection, CUDA-graph steps, and the multi-replica cluster router
(health-aware routing, failover by replay, draining)."""
from repro_torch.serve import (
    cluster,
    degrade,
    engine,
    faults,
    graphs,
    kv_cache,
    lifecycle,
    paged,
    sampler,
    scheduler,
    serve_step,
)

__all__ = [
    "cluster",
    "degrade",
    "engine",
    "faults",
    "graphs",
    "kv_cache",
    "lifecycle",
    "paged",
    "sampler",
    "scheduler",
    "serve_step",
]
