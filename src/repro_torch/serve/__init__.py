"""Serving: ring KV cache, prefill/decode steps, sampler, slot engine."""
