"""The attention kernels' tiles through the port's tuner
(``repro_torch.tune``) against the reference's rules (``repro.tune``,
``repro.kernels.ops``): a partial pin takes the static tile for the free
axis; the DistrAttention backward sweeps its keys with block_q pinned,
resolved lazily when the backward first runs and only under ``measure``;
``off`` runs the static tiles; every wrapper refuses a tile its sources do
not compile, on the CPU too; and the outputs and gradients at tuned tiles
equal the reference's at its own tuned blocks (Pallas in interpret mode)
within the reference's tolerances.  Everything runs on the CPU (plain
versions)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_helpers import one_intra_op_thread  # noqa: E402,F401

from repro.kernels import ops as rops  # noqa: E402
from repro.tune import BlockSizes as RefBlockSizes  # noqa: E402
from repro_torch.core.api import AttentionConfig, attend, resolve_attention_blocks  # noqa: E402
from repro_torch.core.distr_attention import DistrConfig  # noqa: E402
from repro_torch.core.flash_reference import reference_attention  # noqa: E402
from repro_torch.kernels import backward as bwd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_kernel_call  # noqa: E402
from repro_torch.obs.trace import set_recorder  # noqa: E402
from repro_torch.tune import (  # noqa: E402
    Autotuner, BlockSizes, TuneCache, compiled_tiles, distr_bwd_candidates, reset_autotuner,
    static_tile,
)
from repro_torch.tune import autotune  # noqa: E402

CPU = torch.device("cpu")
# The reference's tolerances (tests/test_tune.py): forward parity 2e-5 in
# f32 and 2e-2 in bf16, gradients 5e-5 and 5e-2.
FWD_TOL = {"f32": 2e-5, "bf16": 2e-2}
BWD_TOL = {"f32": 5e-5, "bf16": 5e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _isolate_tuner(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.delenv("REPRO_TUNE", raising=False)
    reset_autotuner(None)
    yield
    reset_autotuner(None)
    set_recorder(None)


def _largest_wins(run_fn, cand):
    del run_fn
    return 1.0 / (cand[0] * cand[1] if isinstance(cand, tuple) else cand)


def _no_sweeps(run_fn, cand):
    raise AssertionError("this resolution must not sweep")


def _qkv(dtype: str, n=256, d=64, hq=2, hkv=1, seed=0):
    """The same numpy draws in both packages' dtypes: ((q, k, v) jax,
    (q, k, v) torch)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((1, h, n, d)).astype(np.float32) for h in (hq, hkv, hkv)]
    jdt, tdt = DTYPES[dtype]
    return (tuple(jnp.asarray(a, jdt) for a in arrs),
            tuple(torch.from_numpy(a).to(tdt) for a in arrs))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def test_partial_pin_gets_static_default(monkeypatch):
    """Pinning one axis never grafts the free one from a tuned pair: the
    free axis takes the static value and no sweep runs, the reference's
    rule, with each package's own static value (the port's kernel tile is
    64 where the reference's is 128)."""
    from repro.core import AttentionConfig as RefAttentionConfig
    from repro.core.api import resolve_attention_blocks as ref_resolve
    from repro.core.distr_attention import DistrConfig as RefDistrConfig
    from repro.tune import Autotuner as RefAutotuner
    from repro.tune import reset_autotuner as ref_reset

    monkeypatch.setenv("REPRO_TUNE", "measure")
    reset_autotuner(Autotuner(timer=_no_sweeps))
    ref_reset(RefAutotuner(timer=_no_sweeps))
    try:
        bs = resolve_attention_blocks(AttentionConfig(impl="pallas_flash", block_q=128),
                                      d=64, n_q=512, dtype="bfloat16", device=CPU)
        ref = ref_resolve(RefAttentionConfig(impl="pallas_flash", block_q=128), d=64, n_q=512)
        assert bs.fwd() == (128, static_tile("flash_fwd", d=64, dtype="bfloat16")[1]) == (128, 64)
        assert ref.fwd() == (128, 128)
        dcfg = DistrConfig(group_size=2, block_q=32).resolved(64, 512, dtype="bfloat16",
                                                              xla=False, device=CPU)
        rcfg = RefDistrConfig(group_size=2, block_q=32, block_k=None).resolved(64, 512)
        assert (dcfg.block_q, dcfg.block_k) == (32, 64) and (rcfg.block_q, rcfg.block_k) == (
            32, 128)
        # The op itself: a pinned block_q runs the static keys, no sweep.
        _, (q, k, v) = _qkv("bf16", n=128)
        before = ops._resolve_flash_blocks(q, k, True, 128, None)
        assert before.fwd() == (128, 64) and before.block_q_dq is None
        ops.flash_attention(q, k, v, causal=True, block_q=128)
    finally:
        ref_reset(None)
    assert not os.path.exists(os.environ["REPRO_TUNE_CACHE"])


def test_distr_bwd_block_k_pinned_block_q(monkeypatch, tmp_path):
    """The DistrAttention backward sweeps its keys only: block_q is the LSH
    grouping granularity and stays pinned, the cache keys carry it
    (``distr_dq@l=128``), a pair among a key's entries is refused; outside
    ``measure`` the forward's keys carry over where the kernel compiles
    them, else its static keys."""
    cands = distr_bwd_candidates("distr_dq", d=64, n=512, group_size=2)
    assert cands == [128, 64] and all(isinstance(c, int) for c in cands)
    # d = 128: the dq kernel compiles 64 keys alone (128 spills), so one candidate.
    assert distr_bwd_candidates("distr_dq", d=128, n=512, group_size=2) == [64]

    monkeypatch.setenv("REPRO_TUNE", "measure")
    path = str(tmp_path / "bwd.json")
    tuner = Autotuner(cache=TuneCache(path), timer=_largest_wins)
    for kernel in ("distr_dq", "distr_dkv"):
        bq, bk = tuner.resolve_distr_bwd(kernel, block_q=128, d=64, n=256, group_size=2,
                                         causal=True, device=CPU)
        assert (bq, bk) == (128, 128)
    entries = json.load(open(path))
    assert {key.split("|")[0] for key in entries} == {"distr_dq@l=128", "distr_dkv@l=128"}
    assert all(e["default"] == 64 and len(e["table"]) == 2 for e in entries.values())

    poisoned = Autotuner(cache=TuneCache(path), timer=_largest_wins)
    key = next(k for k in entries if k.startswith("distr_dq@"))
    poisoned.cache.put(key, {**entries[key], "best": [128, 128]})
    with pytest.raises(AssertionError, match="pinned"):
        poisoned.resolve_distr_bwd("distr_dq", block_q=128, d=64, n=256, group_size=2,
                                   causal=True, device=CPU)

    monkeypatch.setenv("REPRO_TUNE", "off")
    assert tuner.resolve_distr_bwd("distr_dq", block_q=128, d=64, n=256,
                                   fwd_block_k=128) == (128, 128)
    assert tuner.resolve_distr_bwd("distr_dq", block_q=128, d=128, n=256,
                                   fwd_block_k=128) == (128, 64)  # not compiled at d = 128
    assert tuner.resolve_distr_bwd("distr_dkv", block_q=64, d=112, n=256,
                                   fwd_block_k=None) == (64, 64)


def test_distr_bwd_lazy_measure_resolution(monkeypatch, tmp_path):
    """Under ``measure`` a forward-only DistrAttention call sweeps no
    backward key; the first backward sweeps both (with block_q pinned at
    the config's), and its gradients equal those under ``off`` (the plain
    versions take any tile alike)."""
    monkeypatch.setenv("REPRO_TUNE", "measure")
    path = str(tmp_path / "lazy.json")
    reset_autotuner(Autotuner(cache=TuneCache(path), timer=_largest_wins))
    _, (q, k, v) = _qkv("bf16", n=256)
    cfg = DistrConfig(group_size=2, block_q=128)
    with torch.no_grad():
        ops.distr_attention(q, k, v, cfg, causal=True)
    kernels = ({e["kernel"] for e in json.load(open(path)).values()}
               if os.path.exists(path) else set())
    assert not kernels & {"distr_dq", "distr_dkv"}

    def grads():
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        ops.distr_attention(qq, kk, vv, cfg, causal=True).float().sum().backward()
        return qq.grad, kk.grad, vv.grad

    g_meas = grads()
    kernels = {e["kernel"] for e in json.load(open(path)).values()}
    assert {"distr_dq", "distr_dkv"} <= kernels
    assert ops.resolve_distr_bwd_blocks(
        DistrConfig(group_size=2, block_q=128, block_k=64), d=64, n=256, dtype="bfloat16",
        causal=True, device=CPU) == (128, 128)
    monkeypatch.setenv("REPRO_TUNE", "off")
    reset_autotuner(None)
    for a, b in zip(g_meas, grads()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fwd_parity_default_vs_tuned(dtype):
    """``ops.flash_attention`` at a tuned tile (each the port compiles at
    d = 64: in bf16 the tensor-core tiles, in f32 the FMA tile) against
    the reference's ``ops.flash_attention`` at its own tuned pair (256, 64)
    in interpret mode, on the same draws, within the reference's
    tolerance."""
    (qj, kj, vj), (q, k, v) = _qkv(dtype)
    want = rops.flash_attention(qj, kj, vj, causal=True, blocks=RefBlockSizes(256, 64))
    tiles = compiled_tiles("flash_fwd", d=64, dtype="bfloat16" if dtype == "bf16"
                           else "float32")
    for bq, bk in tiles:
        got = ops.flash_attention(q, k, v, causal=True, blocks=BlockSizes(bq, bk))
        _close(got, want, FWD_TOL[dtype], f"tile {bq}x{bk}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bwd_parity_default_vs_tuned(dtype):
    """A training step's gradients through ``ops.flash_attention`` with
    tuned backward tiles (dq and dkv each at a compiled tile other than
    its static one, where the dtype compiles one) against ``jax.grad`` of
    the reference's op at its tuned backward blocks in interpret mode."""
    (qj, kj, vj), (q, k, v) = _qkv(dtype)
    ref_blocks = RefBlockSizes(block_q=128, block_k=128, block_q_dq=64, block_k_dq=256,
                               block_q_dkv=256, block_k_dkv=64)
    want = jax.grad(lambda a, b, c: rops.flash_attention(
        a, b, c, causal=True, blocks=ref_blocks).astype(jnp.float32).sum(),
        argnums=(0, 1, 2))(qj, kj, vj)
    if dtype == "bf16":
        blocks = BlockSizes(block_q=128, block_k=128, block_q_dq=128, block_k_dq=64,
                            block_q_dkv=64, block_k_dkv=128)
        assert blocks.dq() != static_tile("flash_dq", d=64, dtype="bfloat16")
        assert blocks.dkv() != static_tile("flash_dkv", d=64, dtype="bfloat16")
    else:
        blocks = BlockSizes(64, 32, block_q_dq=64, block_k_dq=32, block_q_dkv=32,
                            block_k_dkv=64)
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    ops.flash_attention(qq, kk, vv, causal=True, blocks=blocks).float().sum().backward()
    for got, ref, name in zip((qq.grad, kk.grad, vv.grad), want, "qkv"):
        _close(got, ref, BWD_TOL[dtype], f"d{name}")


def test_wrappers_refuse_a_tile_not_compiled():
    """Every tiled wrapper checks its tile against ``compiled_tiles`` on
    the CPU too: a tile outside them raises, one inside runs the plain
    version, and None is the static tile."""
    _, (q, k, v) = _qkv("bf16", n=64, d=128)
    qf, kf, vf = q[0], k[0], v[0]
    kw = dict(q_per_kv=2, scale=128 ** -0.5, causal=True, kv_len=64)
    with pytest.raises(ValueError, match="not compiled"):
        flash_attention_kernel_call(qf, kf, vf, block_q=32, block_k=64, **kw)
    o, lse = flash_attention_kernel_call(qf, kf, vf, return_lse=True, block_q=128,
                                         block_k=128, **kw)
    delta = bwd.delta_plain(o, o)
    with pytest.raises(ValueError, match="not compiled"):  # spills at d = 128: dropped
        bwd.flash_dq_kernel_call(qf, kf, vf, o, lse, delta, block_q=64, block_k=128, **kw)
    with pytest.raises(ValueError, match="not compiled"):
        bwd.flash_dkv_kernel_call(qf.float(), kf.float(), vf.float(), o.float(), lse, delta,
                                  block_q=32, block_k=128, **kw)  # f32: the FMA tile alone
    assert autotune.check_tile("flash_dkv", (None, None), d=128, dtype="bfloat16") == (32, 64)
    assert autotune.check_tile("flash_dkv", (None, 128), d=128, dtype="bfloat16") == (32, 128)
    assert ("distr_dq", 128, (64, 128)) in autotune.DROPPED_TILES
    assert (64, 128) not in compiled_tiles("distr_dq", d=128, dtype="bfloat16")


def test_off_runs_the_static_tiles():
    """Unset ``REPRO_TUNE``: every resolution a call makes gives the tile
    the kernels ran before their tiles were swept: flash 64 × 64 forward,
    dq 64 × 64, dkv 32 × 64 at d = 128 (64 × 64 at d = 64), DistrAttention
    64 keys forward and backward, f32 the FMA tiles."""
    for d, dkv_rows in ((64, 64), (112, 32), (128, 32)):
        _, (q, k, v) = _qkv("bf16", n=200, d=d)
        blocks = ops._resolve_flash_blocks(q, k, True, None, None)
        assert blocks.fwd() == (64, 64)
        assert ops.bwd_tiles(blocks, d, "bfloat16") == ((64, 64), (dkv_rows, 64))
        cfg = DistrConfig(group_size=2).resolved(d, 200, dtype="bfloat16", xla=False,
                                                 device=CPU)
        assert (cfg.block_q, cfg.block_k) == (128, 64)
        assert ops.resolve_distr_bwd_blocks(cfg, d=d, n=200, dtype="bfloat16",
                                            causal=True) == (64, 64)
    cfg = DistrConfig(group_size=2).resolved(64, 200, dtype="float32", xla=False, device=CPU)
    assert cfg.block_k == 32
    assert ops.resolve_distr_bwd_blocks(cfg, d=64, n=200, dtype="float32",
                                        causal=True) == (32, 64)  # dkv's FMA keys


def test_attend_resolves_and_runs_the_tuned_blocks(monkeypatch, tmp_path):
    """Under ``measure`` ``attend`` sweeps the blocks it runs: ``xla_flash``
    the plain blockwise path's pairs (the reference's candidate space),
    ``pallas_flash`` the kernel's compiled tiles; ``resolve_attention_blocks``
    reports the picks, and both outputs equal the exact attention."""
    monkeypatch.setenv("REPRO_TUNE", "measure")
    path = str(tmp_path / "attend.json")
    reset_autotuner(Autotuner(cache=TuneCache(path), timer=_largest_wins))
    _, (q, k, v) = _qkv("f32", n=256)
    want = reference_attention(q, k, v, causal=True)
    for impl in ("xla_flash", "pallas_flash"):
        cfg = AttentionConfig(impl=impl)
        torch.testing.assert_close(attend(q, k, v, cfg, causal=True), want, atol=2e-5,
                                   rtol=2e-5)
        bs = resolve_attention_blocks(cfg, d=64, n_q=256, dtype="float32", causal=True,
                                      device=CPU)
        entry = next(e for e in json.load(open(path)).values()
                     if e["kernel"] == ("xla_flash" if impl == "xla_flash" else "flash_fwd"))
        assert list(bs.fwd()) == entry["best"]
    entries = {e["kernel"]: e for e in json.load(open(path)).values()}
    assert sorted(tuple(r["candidate"]) for r in entries["xla_flash"]["table"]) == sorted(
        autotune.pair_candidates(64, n=256, w=4))
    assert entries["flash_fwd"]["table"][0]["candidate"] == [64, 32]  # f32: the FMA tile
    assert entries["flash_fwd"]["calls"] == 0


def test_an_unresolved_tile_key_raises_where_sweeps_are_refused(monkeypatch, tmp_path):
    """Inside ``sweeps_refused`` (a decode step) an attention key the memo
    and the cache do not hold raises instead of sweeping; an f32 key, one
    FMA tile and so no sweep, resolves; after a warm-up the same key
    resolves by lookup."""
    from repro_torch.tune import sweeps_refused

    monkeypatch.setenv("REPRO_TUNE", "measure")
    tuner = Autotuner(cache=TuneCache(str(tmp_path / "c.json")), timer=_largest_wins)
    kw = dict(d=64, n=256, causal=True, device=CPU)
    with sweeps_refused("a decode step"):
        with pytest.raises(RuntimeError, match="a decode step"):
            tuner.resolve_pair("flash_dkv", dtype="bfloat16", **kw)
        assert tuner.resolve_pair("flash_dkv", dtype="float32", **kw) == (32, 64)
    pick = tuner.resolve_pair("flash_dkv", dtype="bfloat16", **kw)
    with sweeps_refused("a decode step"):
        assert Autotuner(cache=TuneCache(str(tmp_path / "c.json")), timer=_no_sweeps
                         ).resolve_pair("flash_dkv", dtype="bfloat16", **kw) == pick == (64, 128)


def test_the_ring_resolves_its_backward_keys_at_the_shard(monkeypatch, tmp_path):
    """The ring's DistrAttention backward resolves its keys through the
    single-device op's resolver at the shard one rank streams (the cache
    key's bucket is the shard's, not the global length's), with block_q
    pinned; an explicit ``block_k_bwd`` wins without a sweep."""
    from repro_torch.distributed.ring_attention import _resolve_distr_bwd_pair

    monkeypatch.setenv("REPRO_TUNE", "measure")
    path = str(tmp_path / "ring.json")
    reset_autotuner(Autotuner(cache=TuneCache(path), timer=_largest_wins))
    _, (q, _, _) = _qkv("bf16", n=1024)
    cfg = DistrConfig(group_size=2, block_q=128, block_k=64)
    assert _resolve_distr_bwd_pair(cfg, q, 256, True) == (128, 128)
    assert {key.split("|nb=")[1].split("|")[0] for key in json.load(open(path))} == {"256"}
    reset_autotuner(Autotuner(cache=TuneCache(path), timer=_no_sweeps))
    pinned = DistrConfig(group_size=2, block_q=128, block_k=64, block_k_bwd=64)
    assert _resolve_distr_bwd_pair(pinned, q, 512, True) == (64, 64)
