"""Paged KV cache: a ref-counted block-pool allocator and the pooled tensors.

The slot engine reserves a contiguous ``max_len`` slab per slot.  The paged
cache cuts KV into fixed-size blocks drawn from one shared pool:

  pools:        v (L, P, Hkv, bs, dh), and k (L, P, Hkv, bs, dh) — or,
                for dense under ``attention.distr_decode``, k_fused
                (·, dh/G*) and no raw K at all (GQA dense and moe only)
  block table:  per request, logical block j → physical pool block ids[j]
  invariant:    block 0 is a reserved garbage block, never allocated: the
                write target of padded rows and idle lanes

``BlockPool`` is host-side bookkeeping (free list and ref counts);
``PagedKVCache`` owns the device tensors and the per-request tables:
``allocate_to`` grows a table (raising ``PoolExhausted`` so the scheduler
can preempt), ``free`` returns blocks (ref-counted: shared-prefix blocks
survive until their last holder frees them), ``evict_to_host`` /
``restore`` move a whole request's KV to host tensors and back bit for bit,
and ``share_prefix`` lends a request's full leading blocks to another.
The kernel is ``kernels/paged_decode.py``; the policy is
``serve/scheduler.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.kernels.paged_decode import GARBAGE_BLOCK


class PoolExhausted(Exception):
    """An allocation cannot be satisfied; the scheduler reacts by
    preempting (whole-request eviction to host), never by crashing."""


class BlockPool:
    """Ref-counted fixed-size block allocator (host-side free list).  Block
    ``GARBAGE_BLOCK`` (0) is reserved and never handed out."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("pool needs ≥ 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() → low ids first
        self._refs = [0] * num_blocks
        self._refs[GARBAGE_BLOCK] = 1  # permanently held

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> list[int]:
        """n fresh blocks (refcount 1) or ``PoolExhausted``, all or nothing,
        so a partial grab never deadlocks two growing requests."""
        if n > len(self._free):
            raise PoolExhausted(f"need {n} blocks, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def incref(self, block: int) -> None:
        if self._refs[block] <= 0:
            raise ValueError(f"incref of free block {block}")
        self._refs[block] += 1

    def free(self, block: int) -> None:
        if block == GARBAGE_BLOCK:
            return
        if self._refs[block] <= 0:
            raise ValueError(f"double free of block {block}")
        self._refs[block] -= 1
        if self._refs[block] == 0:
            self._free.append(block)

    def refcount(self, block: int) -> int:
        return self._refs[block]


def check_pageable(cfg) -> None:
    """Raise unless the paged engine serves ``cfg``: GQA dense or moe."""
    if cfg.family not in ("dense", "moe") or cfg.use_mla:
        raise NotImplementedError(
            "paged serving covers GQA dense/moe; use ServeEngine for "
            f"family={cfg.family!r} use_mla={cfg.use_mla}")


def pool_struct(cfg, num_blocks: int, block_size: int) -> dict:
    """Shapes of the paged pools, by key.  GQA dense and moe only (MLA and
    the ssm and hybrid families keep the slot engine).  The fused pool
    replaces raw K, which the fused paged path never reads or writes; it
    engages for dense only, so a moe config with ``distr_decode`` set pools
    raw K, as its paged step reads it."""
    check_pageable(cfg)
    l, hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    shapes = {"v": (l, num_blocks, hkv, block_size, dh)}
    if cfg.attention.distr_decode and cfg.family == "dense":
        g = cfg.attention.distr.group_size
        shapes["k_fused"] = (l, num_blocks, hkv, block_size, dh // g)
    else:
        shapes["k"] = (l, num_blocks, hkv, block_size, dh)
    return shapes


def init_pools(cfg, num_blocks: int, block_size: int, dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    return {key: torch.zeros(shape, dtype=dtype, device=device)
            for key, shape in pool_struct(cfg, num_blocks, block_size).items()}


@dataclass
class _Evicted:
    """Host copy of a preempted request's live KV: per pool key a CPU tensor
    (L, width, Hkv, bs, ·) of its blocks in logical order, possibly padded
    with the garbage block to a fixed width."""
    length: int
    blocks: dict = field(default_factory=dict)
    n_blocks: int = 0  # real (unpadded) table entries


class PagedKVCache:
    """Device pools plus per-request block tables over a :class:`BlockPool`."""

    def __init__(self, cfg, num_blocks: int, block_size: int, dtype=torch.bfloat16,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.pool = BlockPool(num_blocks, block_size)
        self.block_size = block_size
        self.device = torch.device(device)
        self.pools = init_pools(cfg, num_blocks, block_size, dtype, self.device)
        self.tables: dict[int, list[int]] = {}  # uid → physical block ids
        self.evicted: dict[int, _Evicted] = {}

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def allocate_to(self, uid: int, n_tokens: int) -> None:
        """Grow ``uid``'s table to cover ``n_tokens`` positions.  Raises
        ``PoolExhausted`` (table unchanged) when the pool cannot."""
        table = self.tables.setdefault(uid, [])
        need = self.blocks_for(n_tokens) - len(table)
        if need > 0:
            table.extend(self.pool.alloc(need))

    def free(self, uid: int) -> None:
        for b in self.tables.pop(uid, []):
            self.pool.free(b)
        self.evicted.pop(uid, None)

    def table_array(self, uids, max_blocks: int, out: torch.Tensor | None = None) -> torch.Tensor:
        """(len(uids), max_blocks) int32 block-table rows on the pools'
        device; absent or short tables pad with the garbage block.  With
        ``out`` the rows are written into it in place and it is returned."""
        rows = torch.full((len(uids), max_blocks), GARBAGE_BLOCK, dtype=torch.int32)
        for i, uid in enumerate(uids):
            t = self.tables.get(uid, [])
            rows[i, :len(t)] = torch.tensor(t, dtype=torch.int32)
        return rows.to(self.device) if out is None else out.copy_(rows)

    def share_prefix(self, src_uid: int, dst_uid: int, n_tokens: int) -> int:
        """Seed ``dst``'s table with ``src``'s full blocks covering the first
        ``n_tokens`` positions (rounded down to whole blocks: a partial block
        is still written by src and is never shared).  Returns the tokens
        covered; dst starts its prefill there."""
        if self.tables.get(dst_uid):
            raise ValueError(f"dst {dst_uid} already has blocks")
        src = self.tables.get(src_uid, [])
        n_blocks = min(n_tokens // self.block_size, len(src))
        for b in src[:n_blocks]:
            self.pool.incref(b)
        self.tables[dst_uid] = list(src[:n_blocks])
        return n_blocks * self.block_size

    def evict_to_host(self, uid: int, length: int, *, pad_to: int | None = None) -> None:
        """Copy ``uid``'s blocks to host tensors and free them.  Every table
        entry is copied (shared-prefix blocks too: restore writes them back
        as owned blocks).  ``pad_to`` pads the copy to a fixed table width
        with the garbage block, as the reference does to keep its traced
        shapes fixed."""
        table = self.tables.get(uid)
        if not table:
            raise ValueError(f"uid {uid} holds no blocks")
        width = max(pad_to or 0, len(table))
        idx = torch.tensor(table + [GARBAGE_BLOCK] * (width - len(table)),
                           dtype=torch.int64, device=self.device)
        ev = _Evicted(length=length, n_blocks=len(table))
        for key, pool in self.pools.items():
            ev.blocks[key] = pool[:, idx].cpu()  # (L, width, Hkv, bs, ·)
        self.evicted[uid] = ev
        for b in table:
            self.pool.free(b)
        del self.tables[uid]

    def restore(self, uid: int) -> int:
        """Re-allocate and copy back an evicted request's KV; returns its
        live length.  Raises ``PoolExhausted``, with nothing allocated, when
        the pool cannot hold it yet.  Padded rows land in the garbage block,
        whose content is never read."""
        ev = self.evicted[uid]
        width = next(iter(ev.blocks.values())).shape[1]
        blocks = self.pool.alloc(ev.n_blocks)  # all or nothing
        idx = torch.tensor(blocks + [GARBAGE_BLOCK] * (width - len(blocks)),
                           dtype=torch.int64, device=self.device)
        for key, pool in self.pools.items():
            pool[:, idx] = ev.blocks[key].to(self.device, pool.dtype)
        self.tables[uid] = blocks
        del self.evicted[uid]
        return ev.length
