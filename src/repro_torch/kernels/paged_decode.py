"""Block-table (paged) split-K flash-decoding: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/paged_decode.cu``; bf16 on the tensor-core tile
``csrc/decode_tc.cuh`` it shares with the contiguous decode kernel, f32 on
FMA loops) replaces the Pallas TPU kernel
``repro/kernels/paged_decode.py::_paged_decode_kernel``.  KV lives in a
shared block pool ``(P, Hkv, bs, ·)``; logical block ``j`` of request ``b``
is physical block ``block_tables[b, j]``.  One split per logical block
emits the same unnormalised partials as the contiguous decode kernel
(``kernels/decode.py``), merged by ``decode.merge_splits``; a dead block
(``j·bs ≥ length``) emits the identity.  Lengths are not clamped to the
table's capacity: a padded chunked-prefill window may overhang it.
``launches`` counts the wrapper's kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode import decode_plain
from repro_torch.utils.counting import charged

GARBAGE_BLOCK = 0  # pool block 0 is never allocated: dead-lane writes land here

launches = 0


def gather_blocks(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(P, Hkv, bs, d) pool + (B, max_blocks) table → (B, Hkv, max_blocks·bs,
    d) contiguous per-request cache."""
    g = pool[block_tables.to(torch.int64)]  # (B, mb, Hkv, bs, d)
    b, mb, hkv, bs, d = g.shape
    return g.transpose(1, 2).reshape(b, hkv, mb * bs, d)


def paged_decode_plain(q, k_pool, v_pool, block_tables, lengths, *, scale: float,
                       q_len: int):
    """Plain version of the kernel: gather the pools through the table into a
    contiguous cache and run ``decode_plain`` with one split per block.

    q: (B, Hkv, rows, d_score) packed (row r is query token r % q_len);
    k_pool: (P, Hkv, bs, d_score); v_pool: (P, Hkv, bs, d); block_tables:
    (B, max_blocks); lengths: (B,), unclamped.  Positions at or past a
    request's length are zeroed after the gather, so what the table points
    at there (the garbage block) cannot reach the output.
    Returns o (B, Hkv, max_blocks, rows, d) and m, l (B, Hkv, max_blocks,
    rows), f32."""
    bs = v_pool.shape[2]
    k = gather_blocks(k_pool, block_tables).float()
    v = gather_blocks(v_pool, block_tables).float()
    col = torch.arange(k.shape[2], device=k.device)
    dead = (col[None, :] >= lengths.to(torch.int64)[:, None])[:, None, :, None]
    k = k.masked_fill(dead, 0.0)
    v = v.masked_fill(dead, 0.0)
    return decode_plain(q, k, v, lengths, scale=scale, block_k=bs, q_len=q_len)


def _work(q, k_pool, v_pool, block_tables, lengths, *, scale: float, q_len: int) -> dict:
    """The call's least work with the whole table live (static shapes, as
    ``decode``'s)."""
    from repro_torch.kernels.ops import decode_attention_work

    b, hkv, rows, ds = q.shape
    d = v_pool.shape[3]
    capacity = block_tables.shape[1] * v_pool.shape[2]
    return decode_attention_work([capacity] * b, hkv * rows // q_len, hkv, d, capacity,
                                 group_size=d // ds, q_len=q_len,
                                 table_entries=block_tables.shape[1])


@charged("paged_decode", _work)
def paged_decode_kernel_call(q, k_pool, v_pool, block_tables, lengths, *, scale: float,
                             q_len: int):
    """Launch the paged decode kernel; shapes as for ``paged_decode_plain``.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.  q and both pools share one dtype (f32 or bf16)."""
    global launches
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, block_tables, lengths, scale=scale,
                                  q_len=q_len)
    if q.device.type == "meta":  # the dry run: shapes, no launch
        b, hkv, rows, _ = q.shape
        m = torch.empty((b, hkv, block_tables.shape[1], rows), device=q.device,
                        dtype=torch.float32)
        return m.new_empty(m.shape + (v_pool.shape[3],)), m, torch.empty_like(m)
    block_tables = block_tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    build.require_cuda(q, k_pool, v_pool, block_tables, lengths)
    b, hkv, rows, ds = q.shape
    bs, d = v_pool.shape[2], v_pool.shape[3]
    max_blocks = block_tables.shape[1]
    if (k_pool.shape[1:] != (hkv, bs, ds) or v_pool.shape[:3] != k_pool.shape[:3]
            or block_tables.shape[0] != b or lengths.shape != (b,) or ds % 8
            or d not in build.HEAD_DIMS or q_len < 1 or rows % q_len):
        raise ValueError(
            f"paged decode kernel shapes q={tuple(q.shape)} k_pool={tuple(k_pool.shape)} "
            f"v_pool={tuple(v_pool.shape)} block_tables={tuple(block_tables.shape)}"
        )
    if not (k_pool.dtype == v_pool.dtype == q.dtype):
        raise TypeError("paged decode kernel wants q and both pools of one dtype")
    o = torch.empty((b, hkv, max_blocks, rows, d), device=q.device, dtype=torch.float32)
    m = torch.empty((b, hkv, max_blocks, rows), device=q.device, dtype=torch.float32)
    l = torch.empty_like(m)
    err = build.lib().repro_paged_decode_fwd(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(), build.dtype_code(q),
        b, hkv, rows, ds, d, bs, max_blocks, q_len, float(scale), build.stream_handle(q),
    )
    build.check(err, "repro_paged_decode_fwd")
    launches += 1
    return o, m, l
