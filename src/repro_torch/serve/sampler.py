"""Token sampling: greedy / temperature / top-k / top-p.

``temperature <= 0`` is exact greedy whatever the truncation knobs.  top-k
and top-p compose: the top-k cut first, then the smallest nucleus whose
probability mass reaches ``top_p``.  Randomness comes from an explicit
``torch.Generator``.
"""
from __future__ import annotations

import torch

_MASKED = -1e30


def sample(logits: torch.Tensor, *, generator: torch.Generator | None = None,
           temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """(B, 1, V) or (B, V) logits → (B,) int64 next tokens."""
    if logits.ndim == 3:
        logits = logits[:, -1, :]
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, _MASKED, logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        thresh = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, _MASKED, logits)
    if generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
