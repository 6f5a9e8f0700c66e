"""Analytic cost models and roofline terms on an NVIDIA H100 SXM.

The port of ``repro.roofline.analysis`` without its HLO-text walker: the
reference counts a compiled XLA module's FLOPs, bytes and collectives for
its dry runs, which the port has no counterpart of yet.  What is here is
arithmetic on shapes:

  compute    = flops / PEAK_FLOPS
  memory     = hbm_bytes / HBM_BW
  collective = collective_bytes / NVLINK_BW

the analytic per-layer costs of the split-K decode, the paged decode and
the mesh-prefill handoff (the reference's models), the least work of a
decode kernel call for its roofline bound, and MODEL_FLOPS = 6·N_active·D (2·N_active·D
for inference).  ``obs.utilization`` joins a measured time against them.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data-sheet figures (dense, 700 W), not measurements.  A
# card set below 700 W runs slower under load, so a share of these is
# stated beside the card's power limit.
PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # HBM3 bytes/s
PEAK_F32_FLOPS = 67e12  # f32 FLOP/s outside the tensor cores
# NVLink 4 bytes/s each way between two cards of a host.  No one-card
# number uses it: it prices the collective term of a multi-card layout.
NVLINK_BW = 450e9


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_by_op: dict

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower bound assuming perfect overlap: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_dev": self.flops_per_dev,
            "hbm_bytes_per_dev": self.hbm_bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "coll_by_op": self.coll_by_op,
        }


# ---------------------------------------------------------------------------
# Flash-decoding analytic cost models (kernels/decode.py, kernels/paged_decode.py)
# ---------------------------------------------------------------------------


def decode_attention_cost(
    b: int,
    hq: int,
    hkv: int,
    length: int,
    max_len: int,
    d: int,
    *,
    group_size: int = 1,
    block_k: int = 128,
    q_len: int = 1,
) -> dict:
    """FLOPs / bytes model of one split-K decode step (per layer).

    Only ``ceil(length/block_k)`` KV blocks a slot are streamed: KV
    traffic scales with the live length, not the allocated ``max_len``
    (whose cost is ``dense_kv_bytes``, for comparison).  The fused-K̂
    variant (``group_size > 1``) reads the ``d/G*``-wide fused cache in
    the score stage and full V in the value stage.  Split partials (o, m,
    l per split, f32) count one write and one read each over all
    ``max_len/block_k`` splits, as the kernel writes identity partials
    for dead splits and the merge reads every split.
    """
    block_k = min(block_k, max_len)
    live = min(max(length, 1), max_len)
    nk_live = -(-live // block_k) * block_k  # KV blocks actually streamed
    splits_total = -(-max_len // block_k)  # partial buffers are full-size
    d_score = d // group_size
    w = 2  # bf16 cache / activations
    rows = b * hq * q_len

    kv_bytes = w * b * hkv * nk_live * (d_score + d)  # K (or K̂) + V streams
    dense_kv_bytes = w * b * hkv * max_len * (d_score + d)
    q_bytes = w * rows * d_score
    o_bytes = w * rows * d
    partial_bytes = 2 * 4 * b * hq * q_len * splits_total * (d + 2)

    qk_flops = 2 * rows * nk_live * d_score
    pv_flops = 2 * rows * nk_live * d
    softmax_flops = 4 * rows * nk_live
    merge_flops = 4 * rows * splits_total * (d + 2)

    return {
        "kv_bytes": kv_bytes,
        "dense_kv_bytes": dense_kv_bytes,
        "hbm_bytes": kv_bytes + q_bytes + o_bytes + partial_bytes,
        "mxu_flops": qk_flops + pv_flops,
        "total_flops": qk_flops + pv_flops + softmax_flops + merge_flops,
        "splits_live": nk_live // block_k,
    }


def paged_decode_attention_cost(
    b: int,
    hq: int,
    hkv: int,
    length: int,
    max_blocks: int,
    block_size: int,
    d: int,
    *,
    group_size: int = 1,
    q_len: int = 1,
) -> dict:
    """FLOPs / bytes model of one block-table split-K decode step (per
    layer; kernels/paged_decode.py).

    ``ceil(length/block_size)`` pool blocks a request are streamed, plus
    the block table (4 bytes an entry).  ``slab_kv_bytes`` is what the
    slot engine commits for the same request: a full
    ``max_blocks·block_size`` contiguous slab.  The fused-K̂ variant
    (``group_size > 1``) streams the ``d/G*``-wide fused pool in the score
    stage and full V in the value stage.  Split partials (o, m, l, f32)
    span all ``max_blocks`` table entries, dead ones included, so the
    merge term scales with the table width.
    """
    capacity = max_blocks * block_size
    live = min(max(length, 1), capacity)
    live_blocks = -(-live // block_size)
    nk_live = live_blocks * block_size
    d_score = d // group_size
    w = 2  # bf16 pools / activations
    rows = b * hq * q_len

    kv_bytes = w * b * hkv * nk_live * (d_score + d)  # K̂/K + V block streams
    slab_kv_bytes = w * b * hkv * capacity * (d_score + d)
    table_bytes = 4 * b * max_blocks
    q_bytes = w * rows * d_score
    o_bytes = w * rows * d
    partial_bytes = 2 * 4 * b * hq * q_len * max_blocks * (d + 2)

    qk_flops = 2 * rows * nk_live * d_score
    pv_flops = 2 * rows * nk_live * d
    softmax_flops = 4 * rows * nk_live
    merge_flops = 4 * rows * max_blocks * (d + 2)

    return {
        "kv_bytes": kv_bytes,
        "slab_kv_bytes": slab_kv_bytes,
        "table_bytes": table_bytes,
        "hbm_bytes": kv_bytes + table_bytes + q_bytes + o_bytes + partial_bytes,
        "mxu_flops": qk_flops + pv_flops,
        "total_flops": qk_flops + pv_flops + softmax_flops + merge_flops,
        "blocks_live": live_blocks,
    }


def decode_attention_work(
    lengths,
    hq: int,
    hkv: int,
    d: int,
    capacity: int,
    *,
    group_size: int = 1,
    q_len: int = 1,
    table_entries: int = 0,
) -> dict:
    """The least work of one decode kernel call over a batch of requests
    with live ``lengths`` (contiguous or paged): the roofline bound of a
    kernel row (``obs.utilization.kernel_bound``).

    Unlike ``decode_attention_cost`` and ``paged_decode_attention_cost``
    (the reference's models, which round live keys up to whole splits or
    blocks, give every query row every live key and price the f32 split
    partials written and read for every split), this counts what the
    function needs: each request's live keys, at most ``capacity``, read
    once for K (or K̂, ``d/G*`` wide) and V at their ``hkv`` heads; the
    ``q_len`` query rows of a request see the causal band (row i of
    ``q_len`` the keys before ``length − (q_len − 1 − i)``); q, the
    lengths and ``table_entries`` block-table entries a request (int32)
    read once; one merged f32 o, m and l a row written once.
    """
    d_score = d // group_size
    live = sum(min(max(n, 0), capacity) for n in lengths)
    pairs = hq * sum(max(0, min(n - (q_len - 1 - i), capacity))
                     for n in lengths for i in range(q_len))
    b = len(lengths)
    rows = b * hq * q_len
    return {
        "tensor_flops": 2 * (d_score + d) * pairs,
        "f32_flops": 4 * pairs,
        "hbm_bytes": 2 * hkv * live * (d_score + d) + 2 * rows * d_score
        + 4 * b * (1 + table_entries) + 4 * rows * (d + 2),
    }


def mesh_prefill_handoff_cost(
    hq: int,
    hkv: int,
    n: int,
    p: int,
    d: int,
    *,
    group_size: int = 1,
    w: int = 2,
) -> dict:
    """FLOPs / bytes model of one mesh-prefill → paged-decode handoff (per
    layer), per device on a ``p``-way context ring.

    * Ring attention over the ``n``-token prompt: each device holds a
      ``ceil(n/p)``-row query shard and streams every KV shard over
      ``p − 1`` hops (causal sweeps skip future hops, so the rotate
      volume is halved on average).  A causal query row attends ``n/2``
      keys on average.
    * Gather: the per-shard K/V re-assemble to whole arrays (each device
      sends its shard to ``p − 1`` peers).
    * Handoff scatter: the pool-owning device writes the prompt's K/V
      (fused K̂ at width ``d/group_size`` in place of raw K when the
      engine decodes fused) through the block table.

    Seconds follow from the module constants: ``mxu_flops / PEAK_FLOPS``,
    ``(ici_rotate_bytes + ici_gather_bytes) / NVLINK_BW``,
    ``(hbm_stream_bytes + pool_scatter_bytes) / HBM_BW``.  The ``ici_``
    keys keep the reference's names; on the card they are NVLink bytes.
    """
    shard = -(-n // max(p, 1))
    d_score = d // group_size
    rows = hq * shard
    attended = n / 2.0  # causal average

    qk_flops = 2.0 * rows * attended * d
    pv_flops = 2.0 * rows * attended * d
    softmax_flops = 4.0 * rows * attended

    # Per hop one KV shard (K + V) rides the ring; causal rings run half
    # the hops on average.
    ici_rotate_bytes = (p - 1) / 2.0 * w * hkv * shard * 2 * d
    ici_gather_bytes = (p - 1) * w * hkv * shard * 2 * d
    hbm_stream_bytes = w * shard * (2 * hq * d + 2 * hkv * d)  # q, o + k, v
    # Scatter on the pool device: read the n gathered rows, write K̂/K + V.
    pool_scatter_bytes = 2 * w * hkv * n * (d_score + d)

    return {
        "shard_len": shard,
        "mxu_flops": qk_flops + pv_flops,
        "total_flops": qk_flops + pv_flops + softmax_flops,
        "ici_rotate_bytes": ici_rotate_bytes,
        "ici_gather_bytes": ici_gather_bytes,
        "hbm_stream_bytes": hbm_stream_bytes,
        "pool_scatter_bytes": pool_scatter_bytes,
        "hbm_bytes": hbm_stream_bytes + pool_scatter_bytes,
    }


# ---------------------------------------------------------------------------
# MODEL_FLOPS (6·N·D convention)
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    """(key path, leaf) of a nested dict / list of tensors, dict keys as
    given and list positions as their index's string."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, path + (str(i),))
    else:
        yield path, tree


def active_params(cfg, params) -> tuple[int, int]:
    """(total_params, active_params) of the port's nested parameter dict:
    MoE counts routed experts × k/E.

    Embedding tables are left out of the 6ND matmul count (a lookup is not
    a matmul), but a tied table that doubles as the LM head is counted.
    ``lsh_proj`` is not a parameter: the reference draws the LSH
    projection from a key, and training leaves it out
    (``models.lm.trainable``)."""
    total = 0
    active = 0
    for keys, leaf in _leaves({k: v for k, v in params.items() if k != "lsh_proj"}):
        n = 1
        for s in leaf.shape:
            n *= s
        total += n
        if "embed" in keys and "table" in keys:
            if cfg.tie_embeddings:
                active += n  # doubles as LM head
            continue
        if "pos_embed" in keys:
            continue
        if "experts" in keys:
            active += n * cfg.moe_top_k / max(cfg.n_experts, 1)
            continue
        active += n
    return int(total), int(active)


def model_flops(cfg, shape, active: int) -> float:
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens
