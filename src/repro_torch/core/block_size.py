"""Block-size selection (paper §3.3.1) for the GPU the paper wrote it for.

The paper's model (GPU):
  I(l, m) = (N/l) · (l·d + 2·N·d + l·d)      # HBM I/O count: max l wins
  l, m ≡ 0 (mod N'=16)                        # mma.sync's tile quantum
  W_b · M_s / (w·(l·d + 2·m·d)) ≥ 2·N_T       # warp occupancy bound

On the H100 (sm_90) the occupancy bound becomes a fit in one block's
shared memory: 227 KB (the most dynamic shared memory a block may opt in
to on sm_90) must hold the Q tile (l×d) and the K and V tiles (m×d each),
the K/V tiles once for each stage of the kernels' ``cp.async`` ring (2);
with DistrAttention also the sampled Q̂ (l×d/G*) and a fused K̂ (m×d/G*)
a stage.  The accumulators and softmax statistics live in registers, as
in the paper's model, so they take no shared memory.

Selection rule is the paper's: maximise l first (minimises HBM I/O), then
maximise m, subject to fit and 16-alignment.

The port's kernels compile their tiles (``kernels/csrc``), so the tuner
(``repro_torch.tune``) uses this model to rank what stays a run-time knob:
DistrAttention's ``block_q``, the LSH permutation granularity.
"""
from __future__ import annotations

QUANTUM = 16  # mma.sync m16n8k16: the tensor-core tile edge the paper's N' names
SMEM_BYTES = 227 * 1024  # opt-in dynamic shared memory a block, sm_90
STAGES = 2  # K/V copies a cp.async ring keeps in flight
MAX_TILE = 1024  # the largest l and m the search considers


def working_set_bytes(l: int, m: int, d: int, *, w: int = 2, group_size: int = 1) -> int:
    """Shared-memory bytes of one (Q block, K block) step of
    (Distr)FlashAttention: the Q tile l×d and ``STAGES`` copies of the K
    and V tiles m×d, in w-byte elements; with G* > 1 also Q̂ (l×d/G*) and a
    fused K̂ (m×d/G*) a stage."""
    dg = d // group_size
    q_side = l * d * w + (l * dg * w if group_size > 1 else 0)
    kv_side = STAGES * 2 * m * d * w
    k_hat = STAGES * m * dg * w if group_size > 1 else 0
    return q_side + kv_side + k_hat


def io_count(l: int, n: int, d: int) -> int:
    """The paper's I(l, m): HBM element I/Os, independent of m."""
    return (n // l) * (2 * l * d + 2 * n * d)


def select_block_sizes(d: int, *, group_size: int = 1, w: int = 2) -> tuple[int, int]:
    """Pick (l, m): maximise l, then m, subject to the shared-memory fit and
    ``QUANTUM`` alignment (Table 2's procedure with Hopper's constants).
    The reference's signature also takes the sequence length n, which its
    rule never reads; the port leaves it out."""
    l = MAX_TILE
    while l >= QUANTUM:
        m = MAX_TILE
        while m >= QUANTUM:
            if working_set_bytes(l, m, d, w=w, group_size=group_size) <= SMEM_BYTES:
                return (l, m)
            m -= QUANTUM
        l -= QUANTUM
    return (QUANTUM, QUANTUM)  # nothing fits: the smallest aligned tile


def enumerate_block_sizes(d: int, *, group_size: int = 1,
                          w: int = 2) -> list[tuple[int, int, int]]:
    """Every legal (l, m, working_set_bytes): the "best" search of Table 2."""
    out = []
    for l in range(QUANTUM, MAX_TILE + 1, QUANTUM):
        for m in range(QUANTUM, MAX_TILE + 1, QUANTUM):
            ws = working_set_bytes(l, m, d, w=w, group_size=group_size)
            if ws <= SMEM_BYTES:
                out.append((l, m, ws))
    return out
