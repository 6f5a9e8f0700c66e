"""Block-size autotuning (paper §3.3.1, taken to the card).

The analytic model in ``core.block_size`` ranks candidate blocks by the
paper's HBM-I/O objective on Hopper's shared memory; this package measures
the top candidates on the live device and caches the pick (the static
value unless a candidate beats it by more than its timings' spread), keyed by
``(kernel, backend, dtype, d, G*, seq-bucket, causal)``.  Among the keys are
the attention kernels' tiles: a kernel takes the tiles its sources compile
(``compiled_tiles``), ``off`` their static ones (``static_tile``).

Environment:

  REPRO_TUNE=off|analytic|measure   how "auto" (None) blocks resolve;
                                    default off: the static values.
  REPRO_TUNE_CACHE=<path>           the persistent JSON cache.
"""
from repro_torch.tune.block_sizes import BlockSizes
from repro_torch.tune.cache import TuneCache, cache_key, default_cache_path, seq_bucket
from repro_torch.tune.measure import cuda_event_timer, measure_candidates, wall_timer
from repro_torch.tune.autotune import (
    Autotuner,
    compiled_tiles,
    decode_candidates,
    distr_bwd_candidates,
    get_autotuner,
    pair_candidates,
    paged_block_candidates,
    reset_autotuner,
    resolve_block_sizes,
    resolve_decode_block,
    resolve_paged_decode_block,
    static_tile,
    sweeps_refused,
    tune_mode,
    warm_decode,
    warm_engine,
    warm_paged_engine,
)

__all__ = [
    "Autotuner",
    "BlockSizes",
    "TuneCache",
    "cache_key",
    "compiled_tiles",
    "cuda_event_timer",
    "decode_candidates",
    "default_cache_path",
    "distr_bwd_candidates",
    "get_autotuner",
    "measure_candidates",
    "pair_candidates",
    "paged_block_candidates",
    "reset_autotuner",
    "resolve_block_sizes",
    "resolve_decode_block",
    "resolve_paged_decode_block",
    "seq_bucket",
    "static_tile",
    "sweeps_refused",
    "tune_mode",
    "wall_timer",
    "warm_decode",
    "warm_engine",
    "warm_paged_engine",
]
