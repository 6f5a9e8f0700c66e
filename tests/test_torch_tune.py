"""The port's block-size tuner (``repro_torch.tune``) against the
reference's (``repro.tune``) where the contract is shared: the sequence
bucket, the cache key (apart from its backend tag), the dtype label, the
``BlockSizes`` accessors and the decode and paged candidate spaces; the
JSON cache (round trip, merge on save, quarantine, env override, the
port's own default path); deterministic picks from a fake timer, cached
and reused with no second ``tune/measure`` span; the static value kept
unless a candidate beats it by more than the timings' spread; the sweeps'
ragged length mix; a decode step that never sweeps; ``off`` mode equal to
the static blocks; compiled tiles recorded, never swept; the decode, paged and
DistrAttention outputs at tuned splits and blocks equal to the defaults
within the reference's tolerances; and the engines' and the training
launcher's warm-ups.  Everything runs on the CPU (plain versions)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.tune import BlockSizes as RefBlockSizes  # noqa: E402
from repro.tune import autotune as ref_autotune  # noqa: E402
from repro.tune import cache as ref_cache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.api import AttentionConfig, attend, attend_decode  # noqa: E402
from repro_torch.core.api import resolve_attention_blocks  # noqa: E402
from repro_torch.core.block_size import enumerate_block_sizes  # noqa: E402
from repro_torch.core.distr_attention import DistrConfig  # noqa: E402
from repro_torch.core.flash_reference import reference_attention  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs.trace import TraceRecorder, set_recorder  # noqa: E402
from repro_torch.tune import (  # noqa: E402
    Autotuner, BlockSizes, TuneCache, cache_key, decode_candidates, default_cache_path,
    pair_candidates, paged_block_candidates, reset_autotuner, seq_bucket,
)
from repro_torch.tune import autotune  # noqa: E402
from repro_torch.tune.cache import dtype_str  # noqa: E402
from repro_torch.tune.measure import ROUNDS  # noqa: E402

CPU = torch.device("cpu")
# The reference's tolerances (tests/test_tune.py): forward and decode
# parity across blocks 2e-5 in f32 and 2e-2 in bf16.
PARITY_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True)
def _isolate_tuner(monkeypatch, tmp_path):
    """A private cache path, ``REPRO_TUNE`` unset and a fresh process-wide
    tuner in every test; the global trace recorder restored after."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.delenv("REPRO_TUNE", raising=False)
    reset_autotuner(None)
    yield
    reset_autotuner(None)
    set_recorder(None)


def _table_timer(table):
    def timer(run_fn, cand):
        del run_fn
        return table[cand]

    return timer


def _largest_wins(run_fn, cand):
    del run_fn
    return 1.0 / (cand[0] * cand[1] if isinstance(cand, tuple) else cand)


def _spans(rec, name):
    return [e for e in rec.events if e["name"] == name]


# ---------------------------------------------------------------------------
# The shared contract, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 100, 128, 129, 300, 511, 512, 513, 2048, 4097])
def test_seq_bucket_matches_reference(n):
    assert seq_bucket(n) == ref_cache.seq_bucket(n)


@pytest.mark.parametrize("kernel", ["decode", "paged_decode", "distr_fwd", "flash_dq"])
@pytest.mark.parametrize("n,causal", [(300, True), (2048, False)])
def test_cache_key_matches_reference_apart_from_backend(kernel, n, causal):
    kw = dict(dtype="bfloat16", d=128, group_size=2, n=n, causal=causal)
    ours = cache_key(kernel, backend="sm_90", **kw)
    theirs = ref_cache.cache_key(kernel, backend="tpu:compiled", **kw)
    assert ours.replace("backend=sm_90", "backend=tpu:compiled") == theirs


def test_cache_key_stability():
    kw = dict(backend="cpu", dtype="float32", d=64, group_size=2, n=300, causal=True)
    k1 = cache_key("distr_fwd", **kw)
    assert k1 == cache_key("distr_fwd", **{**kw, "n": 511})
    assert k1 != cache_key("distr_fwd", **{**kw, "n": 513})
    for field, val in [("backend", "sm_90"), ("dtype", "bfloat16"), ("d", 128),
                       ("group_size", 1), ("causal", False)]:
        assert k1 != cache_key("distr_fwd", **{**kw, field: val})
    assert k1 != cache_key("decode", **kw)


def test_dtype_str_matches_reference():
    import jax.numpy as jnp

    assert dtype_str(torch.bfloat16) == ref_cache.dtype_str(jnp.bfloat16) == "bfloat16"
    assert dtype_str(torch.float32) == ref_cache.dtype_str(jnp.float32) == "float32"
    assert dtype_str(torch.zeros(1, dtype=torch.bfloat16)) == "bfloat16"
    assert dtype_str(torch.float16) == ref_cache.dtype_str(jnp.float16) == "float32"


@pytest.mark.parametrize("kw", [
    {}, {"block_q": 256, "block_k": 64},
    {"block_q": 128, "block_k": 64, "block_q_dq": 64, "block_k_dq": 64,
     "block_q_dkv": 32, "block_k_dkv": 64},
    {"block_q_dkv": 32}, {"block_k_decode": 512, "num_splits": 4},
], ids=["default", "fwd", "all", "partial", "decode"])
def test_block_sizes_accessors_match_reference(kw):
    ours, theirs = BlockSizes(**kw), RefBlockSizes(**kw)
    for name in ("fwd", "dq", "dkv", "decode"):
        assert getattr(ours, name)() == getattr(theirs, name)()
    assert ours.with_(block_q=64).fwd() == theirs.with_(block_q=64).fwd()
    assert BlockSizes.from_pair(256, 64) == BlockSizes(256, 64)
    assert hash(ours) == hash(BlockSizes(**kw))


@pytest.mark.parametrize("n", [100, 128, 200, 512, 1000, 2048, 4096])
def test_split_candidates_match_reference(n):
    """The decode and paged candidates are the reference's values, every
    one a multiple of the decode tile's 64 keys."""
    assert decode_candidates(n) == ref_autotune.decode_candidates(n)
    assert paged_block_candidates(n) == ref_autotune.paged_block_candidates(n)
    assert all(c % autotune.DT_KEYS == 0 for c in decode_candidates(n)
               + paged_block_candidates(n))


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------


def test_cache_roundtrip_persists(tmp_path):
    path = str(tmp_path / "cache.json")
    entry = {"kernel": "decode", "best": 256, "table": []}
    TuneCache(path).put("some|key", entry)
    assert TuneCache(path).get("some|key") == entry
    assert json.load(open(path))["some|key"]["best"] == 256


def test_cache_merge_on_save(tmp_path):
    """A stale in-memory view does not clobber what another process wrote."""
    path = str(tmp_path / "shared.json")
    a, b = TuneCache(path), TuneCache(path)
    assert b.get("anything") is None
    a.put("ka", {"best": 1})
    b.put("kb", {"best": 2})
    assert set(json.load(open(path))) == {"ka", "kb"}


@pytest.mark.parametrize("bad", [b'{"half": [128,', b'\xff\xfe{"torn": '],
                         ids=["torn_json", "non_utf8"])
def test_corrupt_cache_quarantined(tmp_path, bad):
    path = tmp_path / "c.json"
    path.write_bytes(bad)
    c = TuneCache(str(path))
    assert c.get("anything") is None
    assert (tmp_path / "c.json.corrupt").read_bytes() == bad
    assert not path.exists()
    c.put("k", {"best": 128})
    assert json.load(open(path))["k"]["best"] == 128


def test_cache_load_tolerates_unreadable_path(tmp_path):
    d = tmp_path / "a_directory"
    d.mkdir()
    assert TuneCache(str(d)).get("k") is None


def test_cache_env_override_and_own_default(monkeypatch, tmp_path):
    p = tmp_path / "elsewhere.json"
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(p))
    TuneCache().put("k", {"best": 128})
    assert p.exists() and default_cache_path() == str(p)
    monkeypatch.delenv("REPRO_TUNE_CACHE")
    ours = default_cache_path()
    assert ours.endswith(os.path.join(".cache", "repro_torch", "blocksizes.json"))
    assert ours != ref_cache.default_cache_path()


# ---------------------------------------------------------------------------
# Tuning decisions
# ---------------------------------------------------------------------------


def test_pair_candidates_aligned_fit_and_keep_the_default():
    for d in (64, 128, 256):
        cands = pair_candidates(d, n=4096)
        assert (128, 128) in cands
        assert all(l % 16 == 0 and m % 16 == 0 for l, m in cands)
    assert all(m == 64 for _, m in pair_candidates(128, n=2048, ms=(64,), default=(128, 64)))
    tiles = [(64, 64), (128, 128), (512, 512)]  # the last does not fit at d = 128
    assert pair_candidates(128, n=2048, tiles=tiles, default=(64, 64)) == [(128, 128), (64, 64)]


def test_pruner_never_drops_the_measured_best():
    """With a measurement that follows the paper's objective (I(l, m) =
    (N/l)·(2·l·d + 2·N·d) over real N/l, then fewer KV steps N/m), the
    top-K pruning keeps the candidate the whole legal space would pick."""
    n = 512
    for d in (64, 128, 256):
        for g in (1, 2):
            def cost(c):
                return n / c[0] * (2 * c[0] * d + 2 * n * d) + n / c[1]

            nb = seq_bucket(n)
            full = {(min(l, nb), min(m, nb))
                    for l, m, _ in enumerate_block_sizes(d, group_size=g)}
            assert min(full, key=cost) in pair_candidates(d, n=n, group_size=g)


def test_distr_candidates_are_row_tile_multiples_that_fit():
    for d, g, dtype in ((64, 2, "float32"), (128, 2, "bfloat16"), (112, 4, "bfloat16")):
        cands = autotune.distr_candidates(d, n=2048, group_size=g, dtype=dtype)
        assert 128 in cands and cands == sorted(cands, reverse=True)
        assert all(c % autotune.ROW_TILE == 0 for c in cands)


def test_fake_timer_pick_is_deterministic_cached_and_reused(monkeypatch, tmp_path):
    """A fake timer decides the pick; a second tuner on the same cache
    file resolves by lookup, with no timing and no second ``tune/measure``
    span."""
    monkeypatch.setenv("REPRO_TUNE", "measure")
    path = str(tmp_path / "c.json")
    cands = decode_candidates(512)
    table = {c: 1.0 + ((7 * c) % 13) for c in cands}
    want = min(table, key=table.get)
    calls = []

    def timer(run_fn, cand):
        calls.append(cand)
        return table[cand]

    rec = TraceRecorder()
    set_recorder(rec)
    t1 = Autotuner(cache=TuneCache(path), timer=timer)
    assert t1.resolve_decode(d=64, n=512, device=CPU) == want
    assert t1.resolve_decode(d=64, n=400, device=CPU) == want  # same bucket: memo
    assert sorted(calls) == sorted(cands * ROUNDS)  # interleaved rounds
    assert len(_spans(rec, "tune/measure")) == 1
    picks = _spans(rec, "tune/pick")
    assert len(picks) == 1 and picks[0]["args"]["best"] == want
    t2 = Autotuner(cache=TuneCache(path), timer=timer)
    assert t2.resolve_decode(d=64, n=512, device=CPU) == want
    assert len(calls) == len(cands) * ROUNDS and len(_spans(rec, "tune/measure")) == 1
    entry = json.load(open(path))[cache_key("decode", backend="cpu", dtype="bfloat16", d=64,
                                            n=512)]
    assert entry["best"] == want and len(entry["table"]) == len(cands)


def test_modes(monkeypatch):
    tuner = Autotuner(timer=_table_timer({}))
    monkeypatch.setenv("REPRO_TUNE", "off")
    assert tuner.resolve_decode(d=64, n=1024) == 128
    assert tuner.resolve_paged_decode(d=64, n=1024) == 128
    assert tuner.resolve_distr(d=64, n=1024, group_size=2) == 128
    monkeypatch.setenv("REPRO_TUNE", "analytic")
    assert tuner.resolve_decode(d=64, n=1024) == ref_autotune._analytic_decode(1024)
    assert tuner.resolve_paged_decode(d=64, n=1024) in paged_block_candidates(1024)
    bq = tuner.resolve_distr(d=128, n=4096, group_size=2)
    assert bq == autotune.distr_candidates(128, n=4096, group_size=2)[0] == 256
    monkeypatch.setenv("REPRO_TUNE", "bogus")
    with pytest.raises(ValueError):
        tuner.resolve_decode(d=64, n=128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_off_mode_equals_the_static_blocks(dtype):
    """Unset ``REPRO_TUNE``: the decode split is min(128, S) (the op's
    output bit for bit), a None block_q is 128 and the paged pool's block
    is 128, as before the tuner."""
    gen = torch.Generator().manual_seed(0)
    for s in (96, 300):
        q = torch.randn((2, 4, 1, 64), generator=gen).to(dtype)
        k, v = (torch.randn((2, 2, s, 64), generator=gen).to(dtype) for _ in range(2))
        lens = torch.tensor([s // 2, s])
        got = ops.decode_attention(q, k, v, lengths=lens)
        want = ops.decode_attention(q, k, v, lengths=lens, block_k=min(128, s))
        assert torch.equal(got, want)
    cfg = DistrConfig(group_size=2, block_q=None)
    assert cfg.resolved(64, 300, device=CPU).block_q == 128 == cfg.resolved().block_q
    assert resolve_attention_blocks(AttentionConfig(impl="pallas_distr", distr=cfg), d=64,
                                    n_q=300, device=CPU).block_q == 128


def test_compiled_tiles_resolve_without_a_sweep(monkeypatch, tmp_path):
    """The attention kernels' tiles: ``off`` resolves each key to its
    static tile and ``analytic`` to the largest compiled tile the model
    admits, neither with a sweep; ``measure`` times every compiled tile of
    the flash forward, dq and dkv keys and of the distr backward's keys at
    a pinned block_q (a fake timer: the largest tile wins), and an f32 key,
    whose kernel compiles one FMA tile, is recorded with it and timed
    never."""
    def no_sweeps(run_fn, cand):
        raise AssertionError("off and analytic must not sweep")

    path = str(tmp_path / "c.json")
    d, kw = 128, dict(n=2048, dtype="bfloat16", causal=True, device=CPU)
    monkeypatch.setenv("REPRO_TUNE", "off")
    tuner = Autotuner(cache=TuneCache(path), timer=no_sweeps)
    flash = tuner.resolve("flash", d=d, bwd=True, **kw)
    assert (flash.fwd(), flash.dq(), flash.dkv()) == ((64, 64), (64, 64), (32, 64))
    distr = tuner.resolve("distr", d=d, group_size=2, bwd=True, block_q=128, **kw)
    assert (distr.fwd(), distr.dq(), distr.dkv()) == ((128, 64), (128, 64), (128, 64))
    monkeypatch.setenv("REPRO_TUNE", "analytic")
    flash = tuner.resolve("flash", d=d, **kw)
    assert flash.fwd() == (128, 128) == max(autotune.compiled_tiles("flash_fwd", d=d,
                                                                    dtype="bfloat16"))
    assert not os.path.exists(path)

    monkeypatch.setenv("REPRO_TUNE", "measure")
    rec = TraceRecorder()
    set_recorder(rec)
    timed = []

    def largest(run_fn, cand):
        timed.append(cand)
        return _largest_wins(run_fn, cand)

    tuner = Autotuner(cache=TuneCache(path), timer=largest)
    flash = tuner.resolve("flash", d=d, bwd=True, **kw)
    want = {k: max(autotune.compiled_tiles(k, d=d, dtype="bfloat16"))
            for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    assert (flash.fwd(), flash.dq(), flash.dkv()) == (
        want["flash_fwd"], want["flash_dq"], want["flash_dkv"]) == ((128, 128), (128, 128),
                                                                   (64, 128))
    # d = 128 compiles one distr dq key tile (PERF.md: 128 keys spill): d = 64 has both.
    distr = tuner.resolve("distr", d=64, group_size=2, bwd=True, block_q=128, **kw)
    assert (distr.fwd(), distr.dq(), distr.dkv()) == ((128, 64), (128, 128), (128, 128))
    f32 = tuner.resolve("flash", d=d, bwd=True, **{**kw, "dtype": "float32"})
    assert (f32.fwd(), f32.dq(), f32.dkv()) == ((64, 32), (64, 32), (32, 64))
    entries = json.load(open(path))
    swept = {e["kernel"]: e for e in entries.values() if e["calls"]}
    assert sorted(swept) == ["distr_dkv", "distr_dq", "flash_dkv", "flash_dq", "flash_fwd"]
    for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert sorted(tuple(r["candidate"]) for r in swept[kernel]["table"]) == sorted(
            autotune.compiled_tiles(kernel, d=d, dtype="bfloat16"))
    for kernel in ("distr_dq", "distr_dkv"):
        assert sorted(r["candidate"] for r in swept[kernel]["table"]) == sorted(
            k for _, k in autotune.compiled_tiles(kernel, d=64, dtype="bfloat16"))
    assert any(key.startswith("distr_dq@l=128|") for key in entries)
    records = [e for e in entries.values() if not e["calls"]]
    assert len(records) == 3 and all(len(e["table"]) == 1 and e["table"][0]["seconds"] is None
                                     for e in records)
    assert len(_spans(rec, "tune/measure")) == 5 and len(timed) == ROUNDS * sum(
        len(e["table"]) for e in swept.values())


def test_a_real_sweep_on_the_cpu(monkeypatch, tmp_path):
    """With no injected timer, measure mode times every candidate of the
    decode, paged, distr and flash forward keys with the host clock on the
    CPU's plain versions and keeps a full table (distr's an f32 one: its
    block_q beside the FMA tile's 32 keys)."""
    monkeypatch.setenv("REPRO_TUNE", "measure")
    path = str(tmp_path / "c.json")
    tuner = Autotuner(cache=TuneCache(path))
    assert tuner.resolve_decode(d=64, n=256, dtype="float32", device=CPU) in (64, 128, 256)
    assert tuner.resolve_paged_decode(d=64, n=256, dtype="float32", group_size=2,
                                      device=CPU) in (64, 128, 256)
    assert tuner.resolve_distr(d=64, n=256, dtype="float32", group_size=2, causal=True,
                               device=CPU) in (64, 128, 256)
    assert tuner.resolve_pair("flash_fwd", d=64, n=256, dtype="bfloat16", causal=True,
                              device=CPU) in autotune.compiled_tiles("flash_fwd", d=64,
                                                                     dtype="bfloat16")
    entries = {e["kernel"]: e for e in json.load(open(path)).values()}
    assert set(entries) == {"decode", "paged_decode", "distr_fwd", "flash_fwd"}
    defaults = {"decode": 128, "paged_decode": 128, "distr_fwd": [128, 32],
                "flash_fwd": [64, 64]}
    sizes = {"decode": 3, "paged_decode": 3, "distr_fwd": 3, "flash_fwd": 4}
    for kernel, e in entries.items():
        assert len(e["table"]) == sizes[kernel] and e["default"] == defaults[kernel]
        assert e["calls"] == 1
        assert all(np.isfinite(r["seconds"]) and r["seconds"] > 0 and r["spread"] >= 0
                   for r in e["table"])


def test_pick_keeps_the_static_value_within_the_spread(monkeypatch, tmp_path):
    """A candidate replaces the static 128 only when its median beats 128's
    by more than the spread (max − min) of either's repeated timings; the
    cache entry keeps each candidate's median and spread."""
    assert autotune.pick({128: (1.0, 0.0), 256: (0.9, 0.05)}, 128) == 256
    assert autotune.pick({128: (1.0, 0.2), 256: (0.9, 0.05)}, 128) == 128
    assert autotune.pick({128: (1.0, 0.0), 256: (0.9, 0.1)}, 128) == 128
    assert autotune.pick({64: (0.5, 0.0), 256: (0.9, 0.0)}, 128) == 64
    monkeypatch.setenv("REPRO_TUNE", "measure")
    samples = {64: [1.3, 1.4], 128: [1.0, 1.1, 1.2], 256: [0.95, 0.97]}
    path = tmp_path / "a.json"
    tuner = Autotuner(cache=TuneCache(str(path)), timer=lambda run_fn, c: samples[c])
    assert tuner.resolve_decode(d=64, n=256, device=CPU) == 128
    entry = next(iter(json.load(open(path)).values()))
    assert entry["default"] == entry["best"] == 128
    rows = {r["candidate"]: r for r in entry["table"]}
    assert rows[128]["seconds"] == pytest.approx(1.1)
    assert rows[128]["spread"] == pytest.approx(0.2)
    assert [r["candidate"] for r in entry["table"]] == [256, 128, 64]  # by median
    samples[256] = [0.5, 0.52]
    tuner = Autotuner(cache=TuneCache(str(tmp_path / "b.json")),
                      timer=lambda run_fn, c: samples[c])
    assert tuner.resolve_decode(d=64, n=256, device=CPU) == 256


def test_sweeps_serve_a_ragged_length_mix(monkeypatch, tmp_path):
    """The decode and paged sweeps time ``batch`` requests spread evenly up
    to the capacity, or the caller's mix clamped to [1, n], over one K/V
    copy on the CPU."""
    assert autotune.sweep_lengths(2048, batch=4) == [512, 1024, 1536, 2048]
    assert autotune.sweep_lengths(256, lengths=(0, 100, 9999)) == [1, 100, 256]
    seen = {"decode": [], "paged": []}
    real = {"decode": ops.decode_attention, "paged": ops.paged_decode_attention}

    def spy(name):
        def call(*args, **kw):
            seen[name].append(kw["lengths"].tolist())
            return real[name](*args, **kw)
        return call

    monkeypatch.setattr(ops, "decode_attention", spy("decode"))
    monkeypatch.setattr(ops, "paged_decode_attention", spy("paged"))
    monkeypatch.setenv("REPRO_TUNE", "measure")

    def once(run_fn, cand):
        run_fn()
        return 1.0

    tuner = Autotuner(cache=TuneCache(str(tmp_path / "c.json")), timer=once)
    tuner.resolve_decode(d=32, n=256, dtype="float32", device=CPU, lengths=(5, 200, 256))
    tuner.resolve_paged_decode(d=32, n=256, dtype="float32", device=CPU, batch=2)
    assert seen["decode"] == [[5, 200, 256]] * len(decode_candidates(256)) * ROUNDS
    assert seen["paged"] == [[128, 256]] * len(paged_block_candidates(256)) * ROUNDS


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-2b"])
def test_a_decode_step_never_sweeps(monkeypatch, tmp_path, arch):
    """``make_decode_step(max_len=)`` resolves the decode splits when it is
    built (the self cache, and whisper's cross cache at ``cross_len``: one
    sweep each); the prefill and the first decode step then start no
    ``tune/measure`` span.  A step built without ``max_len`` raises on its
    unresolved split instead of sweeping."""
    from repro_torch.models import lm
    from repro_torch.serve.serve_step import make_decode_step, make_prefill

    base = get_config(arch, reduced=True)
    cfg = base.replace(attention=base.attention.with_impl("pallas_flash"))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    extra = ({"frames": torch.randn((2, 64, cfg.d_model), generator=gen)}
             if cfg.family == "encdec" else
             {"patches": torch.randn((2, cfg.num_patch_tokens, cfg.d_model), generator=gen)})
    pos = torch.full((2,), 12 + (cfg.num_patch_tokens if "patches" in extra else 0))
    monkeypatch.setenv("REPRO_TUNE", "measure")
    reset_autotuner(Autotuner(cache=TuneCache(str(tmp_path / "s.json")), timer=_largest_wins))
    rec = TraceRecorder()
    set_recorder(rec)
    prefill = make_prefill(cfg, 200)  # bucket 256: whisper's cross cache is 64 (128)
    step = make_decode_step(cfg, max_len=200, device="cpu")
    n_sweeps = 2 if cfg.family == "encdec" else 1
    assert len(_spans(rec, "tune/measure")) == n_sweeps
    logits, cache = prefill(params, toks, **extra)
    nxt = logits[:, -1].argmax(-1)[:, None]
    out, _ = step(params, nxt, {k: t.clone() for k, t in cache.items()}, pos)
    assert torch.isfinite(out).all() and len(_spans(rec, "tune/measure")) == n_sweeps
    reset_autotuner(Autotuner(cache=TuneCache(str(tmp_path / "t.json")), timer=_largest_wins))
    with pytest.raises(RuntimeError, match="a decode step may not sweep"):
        make_decode_step(cfg)(params, nxt, cache, pos)
    assert len(_spans(rec, "tune/measure")) == n_sweeps


# ---------------------------------------------------------------------------
# Tuned blocks change the speed, never the result
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_parity_default_vs_tuned(dtype):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((2, 2, 1, 32), generator=gen).to(dtype)
    k, v = (torch.randn((2, 1, 256, 32), generator=gen).to(dtype) for _ in range(2))
    lens = torch.tensor([100, 256])
    base = ops.decode_attention(q, k, v, lengths=lens, block_k=128)
    tol = PARITY_TOL[dtype]
    for bk in decode_candidates(256):
        tuned = ops.decode_attention(q, k, v, lengths=lens, block_k=bk)
        torch.testing.assert_close(tuned.float(), base.float(), atol=tol, rtol=tol)


def _paged(x: torch.Tensor, bs: int, order: torch.Tensor):
    """(B, Hkv, S, d) cache → a (P, Hkv, bs, d) pool whose physical blocks
    follow ``order`` (block 0 reserved) and the (B, S/bs) table."""
    b, hkv, s, d = x.shape
    mb = s // bs
    blocks = x.reshape(b, hkv, mb, bs, d).transpose(1, 2).reshape(b * mb, hkv, bs, d)
    pool = x.new_zeros((1 + b * mb, hkv, bs, d))
    ids = order[: b * mb] + 1
    pool[ids] = blocks
    return pool, ids.reshape(b, mb).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_parity_default_vs_tuned(dtype):
    """The same caches paged at every candidate block size give the output
    at the default 128, a decode tick and a 4-token chunk."""
    gen = torch.Generator().manual_seed(2)
    s = 512
    k, v = (torch.randn((2, 2, s, 64), generator=gen).to(dtype) for _ in range(2))
    lens = torch.tensor([300, 512])
    tol = PARITY_TOL[dtype]
    for q_len in (1, 4):
        q = torch.randn((2, 4, q_len, 64), generator=gen).to(dtype)
        outs = {}
        for bs in paged_block_candidates(s):
            order = torch.randperm(2 * s // bs, generator=torch.Generator().manual_seed(bs))
            k_pool, tables = _paged(k, bs, order)
            v_pool, _ = _paged(v, bs, order)
            outs[bs] = ops.paged_decode_attention(q, k_pool, v_pool, block_tables=tables,
                                                  lengths=lens)
        for bs, out in outs.items():
            torch.testing.assert_close(out.float(), outs[128].float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_distr_parity_default_vs_tuned(dtype):
    """At G* = 1 DistrAttention is exact attention whatever its block_q, so
    every candidate agrees with the default 128 (and the reference oracle);
    at G* = 2 a tuned block runs the same function as that block pinned."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((1, 4, 200, 64), generator=gen).to(dtype)
    k, v = (torch.randn((1, 2, 200, 64), generator=gen).to(dtype) for _ in range(2))
    tol = PARITY_TOL[dtype]
    base = ops.distr_attention(q, k, v, DistrConfig(group_size=1, block_q=128), causal=True)
    for bq in autotune.distr_candidates(64, n=200, group_size=1, dtype=dtype_str(dtype)):
        tuned = ops.distr_attention(q, k, v, DistrConfig(group_size=1, block_q=bq),
                                    causal=True)
        torch.testing.assert_close(tuned.float(), base.float(), atol=tol, rtol=tol)
    if dtype == torch.float32:
        torch.testing.assert_close(base, reference_attention(q, k, v, causal=True),
                                   atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# REPRO_TUNE=measure through the dispatch, the engines and the launcher
# ---------------------------------------------------------------------------


def test_measure_mode_end_to_end(monkeypatch, tmp_path):
    """``attend`` with block_q=None and ``attend_decode`` with no split
    sweep, cache, and compute what the picked blocks pinned compute; a
    pinned block_q sweeps nothing but the decode key."""
    monkeypatch.setenv("REPRO_TUNE", "measure")
    path = str(tmp_path / "e2e.json")
    reset_autotuner(Autotuner(cache=TuneCache(path), timer=_largest_wins))
    gen = torch.Generator().manual_seed(4)
    q = torch.randn((1, 4, 200, 64), generator=gen)
    k, v = (torch.randn((1, 2, 200, 64), generator=gen) for _ in range(2))
    cfg = AttentionConfig(impl="pallas_distr", distr=DistrConfig(group_size=2, block_q=None))
    out = attend(q, k, v, cfg, causal=True)
    picked = resolve_attention_blocks(cfg, d=64, n_q=200, dtype="float32", causal=True,
                                      device=CPU)
    assert picked.block_q == 256  # the fake timer's largest candidate
    pinned = AttentionConfig(impl="pallas_distr", distr=DistrConfig(group_size=2, block_q=256))
    assert torch.equal(out, attend(q, k, v, pinned, causal=True))
    qd = torch.randn((2, 4, 1, 64), generator=gen)
    kc, vc = (torch.randn((2, 2, 128, 64), generator=gen) for _ in range(2))
    lens = torch.tensor([60, 128])
    od = attend_decode(qd, kc, vc, cfg, lengths=lens)
    odr = attend_decode(qd, kc, vc, AttentionConfig(impl="reference"), lengths=lens)
    torch.testing.assert_close(od, odr, atol=2e-5, rtol=2e-5)
    assert torch.equal(od, ops.decode_attention(qd, kc, vc, lengths=lens, block_k=128))
    assert {e["kernel"] for e in json.load(open(path)).values()} == {"distr_fwd", "decode"}

    path2 = str(tmp_path / "e2e2.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path2)
    reset_autotuner(Autotuner(cache=TuneCache(path2), timer=_largest_wins))
    attend(q, k, v, pinned, causal=True)
    assert not os.path.exists(path2)
    attend_decode(qd, kc, vc, pinned, lengths=lens)
    assert {e["kernel"] for e in json.load(open(path2)).values()} == {"decode"}


def test_tuned_block_redraws_the_projection_a_pinned_one_refuses(monkeypatch):
    """The model holds the LSH projection drawn at 128 rows: a tuned
    block_q of another length hashes with the one ``proj_seed`` draws at
    its length; a pinned block_q that disagrees with its projection is
    refused."""
    from repro_torch.core.distr_attention import default_projection

    gen = torch.Generator().manual_seed(5)
    q = torch.randn((1, 2, 300, 64), generator=gen)
    k, v = (torch.randn((1, 1, 300, 64), generator=gen) for _ in range(2))
    proj128 = default_projection(DistrConfig(block_q=128))
    with pytest.raises(ValueError):
        ops.distr_attention(q, k, v, DistrConfig(group_size=2, block_q=256), proj=proj128)
    monkeypatch.setenv("REPRO_TUNE", "analytic")
    cfg = DistrConfig(group_size=2, block_q=None)
    bq = cfg.resolved(64, 300, dtype="float32", xla=False, device=CPU).block_q
    assert bq != 128
    got = ops.distr_attention(q, k, v, cfg, proj=proj128)
    want = ops.distr_attention(q, k, v, DistrConfig(group_size=2, block_q=bq))
    assert torch.equal(got, want)


def _model(arch="minicpm-2b"):
    from repro_torch.models import lm

    cfg = get_config(arch, reduced=True)
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _drain(eng, max_steps: int = 50) -> list:
    done = []
    for _ in range(max_steps):
        done += eng.step()
        if not eng.has_work():
            return done
    raise AssertionError("the engine did not finish")


def test_paged_engine_takes_its_block_from_the_tuner(monkeypatch, tmp_path):
    """``PagedServeEngine(block_size=None)`` under ``measure`` sweeps the
    paged key at construction, shapes its pools by the pick, and a second
    construction resolves from the cache with no new sweep; an explicit
    block_size skips the warm-up."""
    from repro_torch.serve.engine import PagedServeEngine

    monkeypatch.setenv("REPRO_TUNE", "measure")
    path = str(tmp_path / "paged.json")
    table = {c: (0.5 if c == 256 else 1.0) for c in paged_block_candidates(512)}
    reset_autotuner(Autotuner(cache=TuneCache(path), timer=_table_timer(table)))
    rec = TraceRecorder()
    set_recorder(rec)
    cfg, params = _model()
    eng = PagedServeEngine(cfg, params, max_batch=2, max_len=512, device="cpu")
    assert eng.block_size == 256 and eng.tuned_blocks == {"paged_decode": 256}
    assert eng.cache.block_size == 256
    assert len(_spans(rec, "tune/measure")) == 1
    reset_autotuner(Autotuner(cache=TuneCache(path), timer=_table_timer({})))
    again = PagedServeEngine(cfg, params, max_batch=2, max_len=512, device="cpu")
    assert again.block_size == 256 and len(_spans(rec, "tune/measure")) == 1
    pinned = PagedServeEngine(cfg, params, max_batch=2, max_len=512, block_size=64,
                              device="cpu")
    assert pinned.block_size == 64 and pinned.tuned_blocks == {}
    again.add_request([1, 2, 3, 4, 5], max_new_tokens=3)
    assert [len(r.generated) for r in _drain(again)] == [3]


def test_serve_engine_warms_its_keys(monkeypatch, tmp_path):
    """``ServeEngine`` construction resolves the prefill buckets and the
    decode split (``measure``: one sweep, at construction); ``off`` gives
    the static split."""
    from repro_torch.serve.engine import ServeEngine

    cfg, params = _model()
    eng = ServeEngine(cfg, params, max_slots=2, max_len=256, device="cpu")
    assert eng.tuned_blocks["decode"].decode() == 128
    assert set(eng.tuned_blocks) == {"prefill/32", "prefill/64", "prefill/128",
                                     "prefill/256", "decode"}
    monkeypatch.setenv("REPRO_TUNE", "measure")
    path = str(tmp_path / "slot.json")
    reset_autotuner(Autotuner(cache=TuneCache(path), timer=_largest_wins))
    eng = ServeEngine(cfg, params, max_slots=2, max_len=256, device="cpu")
    assert eng.tuned_blocks["decode"].decode() == 256
    assert eng.tuned_blocks["decode"].num_splits == 1
    eng.add_request([3, 1, 4, 1, 5], max_new_tokens=3)
    assert [len(r.generated) for r in _drain(eng)] == [3]
    assert [e["kernel"] for e in json.load(open(path)).values()] == ["decode"]


def test_train_launcher_tune_flag(monkeypatch, tmp_path):
    """``launch.train --tune measure`` resolves the training shape's blocks,
    forward and backward, before the first step: with block_q pinned the
    DistrAttention forward keeps its static keys unswept, and each backward
    kernel's keys are swept over every compiled key tile at that block_q
    (a bf16 step of the reduced config)."""
    from repro_torch.launch import train

    def bf16_config(arch, reduced=False):
        cfg = get_config(arch, reduced=reduced)
        return cfg.replace(compute_dtype="bfloat16")

    monkeypatch.setattr(train, "get_config", bf16_config)
    monkeypatch.setenv("REPRO_TUNE", "off")
    path = tmp_path / "train.json"
    reset_autotuner(Autotuner(cache=TuneCache(str(path)), timer=_largest_wins))
    out = train.main(["--arch", "minicpm-2b", "--reduced", "--device", "cpu",
                      "--impl", "pallas_distr", "--steps", "1", "--batch", "1", "--seq", "64",
                      "--tune", "measure", "--workdir", str(tmp_path / "wd")])
    assert os.environ["REPRO_TUNE"] == "measure"
    assert len(out["history"]) == 1
    entries = json.load(open(path))
    assert sorted(e["kernel"] for e in entries.values()) == ["distr_dkv", "distr_dq"]
    d = get_config("minicpm-2b", reduced=True).head_dim_
    for key, e in entries.items():
        assert key.startswith(f"{e['kernel']}@l=32|")
        assert sorted(r["candidate"] for r in e["table"]) == sorted(
            k for _, k in autotune.compiled_tiles(e["kernel"], d=d, dtype="bfloat16"))
        assert e["best"] == 128  # the fake timer's largest
