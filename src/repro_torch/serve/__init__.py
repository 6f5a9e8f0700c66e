"""Serving: ring KV cache and slot engine; block-pool KV, continuous-batching
scheduler and paged engine; steps, sampler, lifecycle, degradation dial."""
