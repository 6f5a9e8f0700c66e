"""The tuned-block-size record a dispatch site resolves
(``repro.tune.block_sizes``).

One frozen (hashable) dataclass covers the block knobs of the kernels:

  * forward (l, m) = ``(block_q, block_k)``;
  * the backward dQ kernel's blocks;
  * the backward dKV kernel's blocks;
  * the decode split-K ``block_k`` (the split length; ``num_splits`` is
    derived from the cache capacity and kept for reporting).

``None`` fields fall back to the forward pair, so a bare
``BlockSizes(128, 128)`` reproduces the static blocks.  In the port the
flash tiles and the backward tiles are compiled into the kernels
(``kernels/csrc``); the tuner reports them here as the kernels run them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class BlockSizes:
    block_q: int = 128
    block_k: int = 128
    # Backward dQ kernel (None → fwd pair).
    block_q_dq: int | None = None
    block_k_dq: int | None = None
    # Backward dKV kernel (None → fwd pair).
    block_q_dkv: int | None = None
    block_k_dkv: int | None = None
    # Decode split-K: split length along the KV axis (None → 128).
    block_k_decode: int | None = None
    # Derived, informational: ceil(cache_len / block_k_decode) at tune time.
    num_splits: int | None = None

    def fwd(self) -> tuple[int, int]:
        return (self.block_q, self.block_k)

    def dq(self) -> tuple[int, int]:
        return (
            self.block_q_dq if self.block_q_dq is not None else self.block_q,
            self.block_k_dq if self.block_k_dq is not None else self.block_k,
        )

    def dkv(self) -> tuple[int, int]:
        return (
            self.block_q_dkv if self.block_q_dkv is not None else self.block_q,
            self.block_k_dkv if self.block_k_dkv is not None else self.block_k,
        )

    def decode(self) -> int:
        return self.block_k_decode if self.block_k_decode is not None else 128

    def with_(self, **kw) -> "BlockSizes":
        return replace(self, **kw)

    @staticmethod
    def from_pair(block_q: int, block_k: int) -> "BlockSizes":
        return BlockSizes(block_q=int(block_q), block_k=int(block_k))
