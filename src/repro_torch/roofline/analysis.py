"""Cost models, roofline terms and the per-rank cost counter on an NVIDIA
H100 SXM.

The port of ``repro.roofline.analysis``.  Three terms a step, per rank:

  compute    = flops / PEAK_FLOPS
  memory     = hbm_bytes / HBM_BW
  collective = collective_bytes / NVLINK_BW

The reference reads them off a compiled, SPMD-partitioned XLA module with
its HLO-text walker (``hlo_cost``).  Eager PyTorch has no such module, so
the port counts one rank's step as it runs: ``CostCounter`` is a dispatch
mode that records the FLOPs of the aten ops (``torch.utils.flop_counter``'s
formulas), HBM bytes by a stated model, each kernel call's least work and
the bytes each collective puts on the wire, by the reference's five kinds
(``COLLECTIVE_OPS``).  ``roofline(cost)`` turns a count into
``RooflineTerms``.  The dry run (``launch.dryrun``) runs the same step on
the meta device under the counter, and the card's run under it counts the
same.

Also here: the analytic per-layer costs of the split-K decode, the paged
decode and the mesh-prefill handoff (the reference's models), the least
work of a decode kernel call for its roofline bound, and MODEL_FLOPS =
6·N_active·D (2·N_active·D for inference).  ``obs.utilization`` joins a
measured time against them.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.utils import counting
from repro_torch.utils.tree import tree_bytes, tree_leaves

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
# The per-rank cost counter (the reference's HLO walker's counterpart)
# ---------------------------------------------------------------------------

# The reference's collective kinds.  The port's five wire sites
# (``distributed.collectives``) charge them: ``all_reduce``, ``all_gather``,
# ``reduce_scatter``, ``all_to_all`` and ``send_recv`` (the ring's hops and
# ``permute``, a collective-permute).
COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# Ops whose operands count as read from HBM beside their output (the bytes
# model below), as the reference counts dot and convolution operands.
_OPERAND_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "convolution",
                          "convolution_backward"})

def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


class CostCounter(TorchDispatchMode):
    """Counts one rank's step as it runs (a context manager):

    * ``flops``: the FLOPs of the aten ops (``torch.utils.flop_counter``'s
      formulas: matmuls, convolutions, attention ops) plus each kernel
      call's least work, tensor-core and f32 alike;
    * ``hbm_bytes``: each op's output bytes (a view writes none), plus the
      operand bytes of matmuls, kernel calls and collectives.  This models
      an eager program, which writes every intermediate: it is not
      comparable with the reference's count of a fused XLA module;
    * ``kernels``: {name: [calls, flops, bytes]} of the kernel calls, each
      charged its least work (``kernels.ops.attention_work``, ``delta_work``,
      ``ssd_work``, ``decode_attention_work``) with the aten ops inside it
      not counted, so its plain version on the CPU, the kernel on the card
      and the meta branch all charge the same (the kernels and the
      collectives report through ``utils.counting``, which needs nothing
      of this module);
    * ``coll``: the bytes each collective hands the wire, by
      ``COLLECTIVE_OPS`` kind.

    With ``track_memory`` it also follows the storages the ops allocate
    (``live_bytes``, ``peak_bytes``): a storage counts from the op that makes
    it until the last tensor on it is gone, meta tensors included, so the
    dry run has a peak to set beside the card's allocator.  Storages that
    exist before the counter starts (the step's arguments) are not counted.
    Counters nest; only the innermost counts."""

    def __init__(self, *, track_memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll = {op: 0 for op in COLLECTIVE_OPS}
        self.kernels: dict = {}
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: dict = {}
        self._quiet = 0

    def __enter__(self):
        counting.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        counting.pop(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet:
            packet = func._overloadpacket
            formula = _flop_registry().get(packet)
            if formula is not None:
                self.flops += float(formula(*args, **kwargs, out_val=out))
            if not func.is_view:
                self.hbm_bytes += tree_bytes(out)
            if packet.__name__ in _OPERAND_OPS:
                self.hbm_bytes += tree_bytes(args)
        if self.track_memory:
            self._track((args, tuple(kwargs.values())), out)
        return out

    def _track(self, args, out) -> None:
        """Follow the storages ``out`` allocates: a storage that no input
        of the op holds is new; each tensor on a followed storage holds it
        until the tensor is gone (a tensor autograd saved lives until the
        backward frees it)."""
        inputs = set()
        for t in tree_leaves(args):
            key = _storage_key(t)
            if key is not None:
                inputs.add(key)
        for t in tree_leaves(out):
            key = _storage_key(t)
            if key is None or (key in inputs and key not in self._storages):
                continue
            entry = self._storages.get(key)
            if entry is None:
                size = t.untyped_storage().nbytes()
                entry = self._storages[key] = [size, 0]
                self.live_bytes += size
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            entry[1] += 1
            weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._storages[key]

    @contextlib.contextmanager
    def quiet(self):
        """Count no aten op inside (a kernel call's or a collective's own
        ops, charged as a whole)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def charge_kernel(self, name: str, work: dict) -> None:
        flops = float(work["tensor_flops"] + work["f32_flops"])
        self.flops += flops
        self.hbm_bytes += work["hbm_bytes"]
        row = self.kernels.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += work["hbm_bytes"]

    def charge_collective(self, kind: str, nbytes: int) -> None:
        self.coll[kind] += int(nbytes)
        self.hbm_bytes += nbytes

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.hbm_bytes, "coll": dict(self.coll),
                "kernels": {k: list(v) for k, v in self.kernels.items()}}


@functools.cache
def _flop_registry() -> dict:
    from torch.utils.flop_counter import flop_registry

    return flop_registry


def collective_bytes(cost) -> dict[str, int]:
    """Per-rank collective operand bytes by kind, of a ``CostCounter`` or
    its ``as_dict()``."""
    co = cost.coll if isinstance(cost, CostCounter) else cost["coll"]
    return {op: int(co.get(op, 0)) for op in COLLECTIVE_OPS}


def roofline(cost) -> RooflineTerms:
    """The three terms of a count (a ``CostCounter`` or its ``as_dict()``)
    at the H100's data-sheet rates.  The collective term prices every byte
    at ``NVLINK_BW``: a mesh that crosses nodes moves some over slower
    links, so there it is a lower bound."""
    d = cost.as_dict() if isinstance(cost, CostCounter) else cost
    flops, bytes_ = float(d["flops"]), float(d["bytes"])
    coll = {k: float(v) for k, v in collective_bytes(d).items()}
    coll_total = float(sum(coll.values()))
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=bytes_ / HBM_BW,
        collective_s=coll_total / NVLINK_BW,
        flops_per_dev=flops,
        hbm_bytes_per_dev=bytes_,
        coll_bytes_per_dev=coll_total,
        coll_by_op=coll,
    )


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


def decode_attention_work(*args, **kwargs) -> dict:
    """``kernels.ops.decode_attention_work``, the least work of a decode
    kernel call, which lives beside the other kernels' (imported on call:
    the kernels import nothing of this module)."""
    from repro_torch.kernels.ops import decode_attention_work as work

    return work(*args, **kwargs)


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
