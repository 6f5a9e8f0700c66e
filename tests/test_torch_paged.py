"""Port parity on the paged serving path, on the CPU, against the JAX package
(Pallas kernels in interpret mode, as tests/test_paged.py runs them).

The paged op and its banded oracle, the block pool and the paged cache, the
continuous-batching scheduler under a tick clock (a fake engine, no model),
``make_paged_step`` and the degraded whole-prompt prefill on starcoder2-7b
``reduced()`` (2 layers, GQA 4/2, f32) with the reference's weights, LSH
projection and static perms carried across, and ``PagedServeEngine``'s greedy
tokens with and without preemption and past capacity.  The paged step and
the greedy tokens also run qwen1.5-4b (MHA 4/4) and qwen2.5-32b (GQA 4/2)
``reduced()``, their QKV biases drawn from a seed in both packages, and the
MoE config llama4-scout-17b-a16e ``reduced()`` (its paged step, greedy
tokens and preemptions; with ``distr_decode`` set it pools and reads raw K,
as the reference does); both packages' paged engines refuse MLA
(deepseek-v2-236b)."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.api import AttentionConfig as RefAttentionConfig  # noqa: E402
from repro.core.api import attend_decode as ref_attend_decode  # noqa: E402
from repro.core.distr_attention import compute_block_permutations as ref_block_perms  # noqa: E402,E501
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve import degrade as ref_degrade  # noqa: E402
from repro.serve import kv_cache as ref_kvc  # noqa: E402
from repro.serve import lifecycle as ref_lifecycle  # noqa: E402
from repro.serve import paged as ref_paged  # noqa: E402
from repro.serve import scheduler as ref_scheduler  # noqa: E402
from repro.serve.engine import PagedServeEngine as RefPagedEngine  # noqa: E402
from repro.serve.serve_step import make_degraded_paged_prefill as ref_degraded_prefill  # noqa: E402,E501
from repro.serve.serve_step import make_paged_step as ref_make_paged_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.api import AttentionConfig, attend_decode  # noqa: E402
from repro_torch.core.distr_attention import compute_block_permutations as port_block_perms  # noqa: E402,E501
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode as pd  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.serve import degrade, kv_cache, lifecycle, paged, scheduler  # noqa: E402
from repro_torch.serve.engine import PagedServeEngine  # noqa: E402
from repro_torch.serve.serve_step import make_degraded_paged_prefill, make_paged_step  # noqa: E402,E501
from _torch_helpers import load_reduced_models, one_intra_op_thread  # noqa: E402,F401

ARCH = "starcoder2-7b"
QWEN = ("qwen1.5-4b", "qwen2.5-32b")
LLAMA4 = "llama4-scout-17b-a16e"


def _t(x):
    """numpy or jax array → f32 torch tensor."""
    return torch.from_numpy(np.array(x, np.float32))


def _pool_case(seed, b, hkv, d, bs, mb):
    """Pools and a shuffled (non-contiguous) block table per request, numpy."""
    rng = np.random.default_rng(seed)
    p = 1 + b * mb  # + the reserved garbage block 0
    k_pool = rng.standard_normal((p, hkv, bs, d), np.float32)
    v_pool = rng.standard_normal((p, hkv, bs, d), np.float32)
    ids = np.arange(1, p, dtype=np.int32)
    rng.shuffle(ids)
    return k_pool, v_pool, ids.reshape(b, mb), rng


# ---------------------------------------------------------------------------
# The paged op against the reference op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_per_kv", [1, 4])
def test_paged_op_matches_reference_ragged(dtype, q_per_kv):
    """Ragged lengths (a block multiple, mid-block, crossing, one token)
    over shuffled physical blocks."""
    b, hkv, d, bs, mb = 4, 2, 32, 8, 4
    k_pool, v_pool, bt, rng = _pool_case(0, b, hkv, d, bs, mb)
    q = rng.standard_normal((b, hkv * q_per_kv, 1, d), np.float32)
    lengths = np.asarray([16, 13, 25, 1], np.int32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    want = ref_ops.paged_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k_pool, jdt), jnp.asarray(v_pool, jdt),
        block_tables=jnp.asarray(bt), lengths=jnp.asarray(lengths))
    got = ops.paged_decode_attention(
        _t(q).to(tdt), _t(k_pool).to(tdt), _t(v_pool).to(tdt),
        block_tables=torch.from_numpy(bt), lengths=torch.from_numpy(lengths))
    assert got.dtype == tdt
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["banded", "overhang"])
def test_paged_op_matches_reference_window(case):
    """A chunked-prefill window (q_len 4): row i sees positions
    < length − (q_len − 1 − i); and a padded window whose length overhangs
    the table's capacity, which must not shift the live rows' bands."""
    if case == "banded":
        b, mb, lengths = 2, 4, [17, 9]
    else:  # capacity 16, pos 13, length 13 + 4 = 17
        b, mb, lengths = 1, 2, [17]
    hkv, d, bs, ql = 2, 32, 8, 4
    k_pool, v_pool, bt, rng = _pool_case(1, b, hkv, d, bs, mb)
    q = rng.standard_normal((b, 4, ql, d), np.float32)
    lengths = np.asarray(lengths, np.int32)
    want = ref_ops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        block_tables=jnp.asarray(bt), lengths=jnp.asarray(lengths))
    got = ops.paged_decode_attention(
        _t(q), _t(k_pool), _t(v_pool), block_tables=torch.from_numpy(bt),
        lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("impl", ["pallas_flash", "reference"])
def test_paged_fused_variant_matches_reference(impl):
    """The fused-K̂ pool (score width d/G*) through the table, by the kernel
    op and by the banded gather oracle, against the reference's same impl;
    ``kv_cache.fuse_new_k`` and ``sample_q`` against the reference's."""
    b, hkv, q_per_kv, d, g, bs, mb = 2, 2, 2, 32, 2, 8, 3
    k_pool, v_pool, bt, rng = _pool_case(2, b, hkv, d, bs, mb)
    perm = np.stack([rng.permutation(d) for _ in range(hkv)]).astype(np.int32)
    kf_pool = np.asarray(ref_kvc.fuse_new_k(jnp.asarray(k_pool), jnp.asarray(perm), g))
    np.testing.assert_allclose(
        kv_cache.fuse_new_k(_t(k_pool), torch.from_numpy(perm), g).numpy(), kf_pool,
        rtol=1e-6, atol=1e-6)
    q = rng.standard_normal((b, hkv * q_per_kv, 2, d), np.float32)
    np.testing.assert_array_equal(
        kv_cache.sample_q(_t(q), torch.from_numpy(perm), g, q_per_kv).numpy(),
        np.asarray(ref_kvc.sample_q(jnp.asarray(q), jnp.asarray(perm), g, q_per_kv)))
    lengths = np.asarray([11, 24], np.int32)
    kw = dict(group_size=g, scale=d ** -0.5)
    want = ref_attend_decode(
        jnp.asarray(q), None, jnp.asarray(v_pool), RefAttentionConfig(impl=impl),
        lengths=jnp.asarray(lengths), k_fused=jnp.asarray(kf_pool), perm=jnp.asarray(perm),
        block_tables=jnp.asarray(bt), **kw)
    got = attend_decode(
        _t(q), None, _t(v_pool), AttentionConfig(impl=impl), lengths=torch.from_numpy(lengths),
        k_fused=_t(kf_pool), perm=torch.from_numpy(perm), block_tables=torch.from_numpy(bt),
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_plain_version_never_reads_the_garbage_block():
    """Dead table entries point at block 0; NaN there must not reach the
    output, and dead blocks emit the identity (o = 0, m = -1e30, l = 0)."""
    b, hkv, d, bs, mb = 2, 2, 32, 8, 4
    k_pool, v_pool, bt, rng = _pool_case(3, b, hkv, d, bs, mb)
    bt[0, 2:] = pd.GARBAGE_BLOCK
    q = _t(rng.standard_normal((b, hkv, 3, d), np.float32))
    lengths = torch.tensor([13, 32])
    kw = dict(scale=d ** -0.5, q_len=1)
    clean = pd.paged_decode_plain(q, _t(k_pool), _t(v_pool), torch.from_numpy(bt), lengths,
                                  **kw)
    k_pool[0], v_pool[0] = np.nan, np.nan
    o, m, l = pd.paged_decode_plain(q, _t(k_pool), _t(v_pool), torch.from_numpy(bt),
                                    lengths, **kw)
    for got, want in zip((o, m, l), clean):
        assert torch.equal(got, want)
    assert bool((o[0, :, 2:] == 0).all()) and bool((m[0, :, 2:] == -1e30).all())
    assert bool((l[0, :, 2:] == 0).all())


# ---------------------------------------------------------------------------
# Block pool and paged cache
# ---------------------------------------------------------------------------


def test_block_pool_invariants():
    pool = paged.BlockPool(5, 8)  # 4 allocatable (block 0 reserved)
    assert pool.num_free == 4
    got = pool.alloc(4)
    assert 0 not in got and len(set(got)) == 4
    with pytest.raises(paged.PoolExhausted):
        pool.alloc(1)
    pool.free(got[0])
    assert pool.num_free == 1
    with pytest.raises(ValueError):
        pool.free(got[0])  # double free
    pool.incref(got[1])  # a shared block survives its first free
    pool.free(got[1])
    assert pool.refcount(got[1]) == 1 and pool.num_free == 1
    pool.free(got[1])
    assert pool.num_free == 2
    pool.free(0)  # the garbage block is never handed out and never freed
    assert pool.refcount(0) == 1


def test_shared_prefix_and_evict_restore_roundtrip():
    cfg = get_config("minicpm-2b", reduced=True)
    cache = paged.PagedKVCache(cfg, 8, 8, dtype=torch.float32, device="cpu")
    cache.allocate_to(0, 20)  # 3 blocks
    assert cache.share_prefix(0, 1, 20) == 16  # whole blocks only
    assert cache.tables[1] == cache.tables[0][:2]
    free_before = cache.pool.num_free
    cache.free(0)  # the shared blocks stay alive through uid 1
    assert cache.pool.num_free == free_before + 1
    cache.free(1)
    assert cache.pool.num_free == cache.pool.num_blocks - 1

    cache.allocate_to(7, 20)
    for key, pool in cache.pools.items():
        pool.copy_(torch.arange(pool.numel(), dtype=torch.float32).reshape(pool.shape))
    want = {key: pool[:, cache.tables[7]].clone() for key, pool in cache.pools.items()}
    cache.evict_to_host(7, 20, pad_to=4)
    assert 7 not in cache.tables and cache.pool.num_free == cache.pool.num_blocks - 1
    for pool in cache.pools.values():
        pool.zero_()
    assert cache.restore(7) == 20
    for key, pool in cache.pools.items():
        assert torch.equal(pool[:, cache.tables[7]], want[key])


def test_fused_pool_drops_raw_k():
    cfg = get_config(ARCH, reduced=True)
    cfg = cfg.replace(attention=replace(cfg.attention, distr_decode=True))
    shapes = paged.pool_struct(cfg, 5, 8)
    assert set(shapes) == {"v", "k_fused"}
    assert shapes["k_fused"][-1] == cfg.head_dim_ // cfg.attention.distr.group_size


def test_lifecycle_schema_matches_reference():
    assert lifecycle.COUNTER_KEYS == ref_lifecycle.COUNTER_KEYS
    assert lifecycle.METRIC_KEYS == ref_lifecycle.METRIC_KEYS
    assert lifecycle.counters_view({"shed": 2}) == ref_lifecycle.counters_view({"shed": 2})


# ---------------------------------------------------------------------------
# Scheduler against the reference scheduler (fake engine, tick clock)
# ---------------------------------------------------------------------------


class _FakeReq:
    def __init__(self, uid, n_prompt, max_new, **deadlines):
        self.uid = uid
        self.prompt = list(range(1, n_prompt + 1))
        self.max_new_tokens = max_new
        self.eos_id = None
        self.generated = []
        self.done = False
        self.deadline_ttft = deadlines.get("ttft")
        self.deadline_e2e = deadlines.get("e2e")


class _FakeEngine:
    """The scheduler's primitive surface over a bare BlockPool of one
    package (``mod``): policy only, no model."""

    window_decode = False

    def __init__(self, mod, scheduler, num_blocks, block_size, max_batch, capacity,
                 bad_decode=(), bad_prefill=()):
        self.mod = mod
        self.scheduler = scheduler
        self.pool = mod.BlockPool(num_blocks, block_size)
        self.bs = block_size
        self.max_batch = max_batch
        self.capacity_tokens = capacity
        self.bad_decode, self.bad_prefill = set(bad_decode), set(bad_prefill)
        self.ids: dict[int, list[int]] = {}
        self.log = {"evicted": [], "first_token": [], "degraded": []}

    def free_lane(self):
        return next(l for l in range(self.max_batch) if l not in self.scheduler.running)

    def alloc(self, entry, n_tokens):
        need = -(-n_tokens // self.bs) - len(self.ids.get(entry.uid, []))
        if need <= 0:
            return True
        try:
            self.ids.setdefault(entry.uid, []).extend(self.pool.alloc(need))
        except self.mod.PoolExhausted:
            return False
        return True

    def can_admit(self, entry):
        need = -(-min(len(entry.req.prompt) + 1, self.capacity_tokens) // self.bs)
        return self.pool.num_free >= need

    def holds_blocks(self, entry):
        return bool(self.ids.get(entry.uid))

    def evict(self, entry):
        for b in self.ids.pop(entry.uid):
            self.pool.free(b)
        self.log["evicted"].append(entry.uid)

    def restore(self, entry):
        try:
            self.ids[entry.uid] = self.pool.alloc(-(-max(entry.length, 1) // self.bs))
        except self.mod.PoolExhausted:
            return False
        return True

    def release(self, entry):
        for b in self.ids.pop(entry.uid, []):
            self.pool.free(b)

    def sample_one(self, logits):
        uid = int(logits)
        self.log["first_token"].append(uid)
        return uid % 7 + 1

    def _row(self, entry):
        return float("nan") if entry.uid in self.bad_prefill else float(entry.uid)

    def prefill_chunk_run(self, entry, chunk):
        return self._row(entry)

    def prefill_full_run(self, entry, group):
        self.log["degraded"].append((entry.uid, group))
        return self._row(entry)

    def decode_tick(self, running):
        toks = np.arange(self.max_batch, dtype=np.int64) + len(self.log["first_token"])
        ok = np.asarray([l not in running or running[l].uid not in self.bad_decode
                         for l in range(self.max_batch)])
        return toks, ok


SCENARIOS = {
    # Many requests through a tight pool: FCFS first tokens, nobody starves.
    "fcfs": dict(pool=(7, 8, 3, 32), chunk=8, reqs=[(10, 5)] * 8),
    # The growing request is itself the newest holder: it self-preempts.
    "lifo": dict(pool=(6, 8, 2, 40), chunk=32, reqs=[(17, 12), (10, 10)]),
    # Room for ~2 live requests, 4 submitted: preempt and resume.
    "pressure": dict(pool=(9, 8, 4, 32), chunk=8, reqs=[(10, 16)] * 4),
    # Shedding, deadlines, cancel, numeric quarantine and the degrade dial.
    "lifecycle": dict(
        pool=(9, 8, 3, 32), chunk=8, max_waiting=7, cancel={3: 3},
        degrade=dict(group_sizes=(2, 4), high_watermark=2, low_watermark=0, up_after=1,
                     down_after=2),
        bad_decode={1}, bad_prefill={6},
        reqs=[(10, 6), (12, 6), (9, 4, dict(e2e=3.0)), (20, 5), (6, 3, dict(ttft=1.0)),
              (10, 8), (7, 2), (11, 4)],
    ),
}


def _drive(sched_mod, degrade_mod, pool_mod, sc):
    now = [0.0]
    deg = sc.get("degrade")
    sched = sched_mod.Scheduler(
        sched_mod.SchedulerConfig(max_batch=sc["pool"][2], prefill_chunk=sc["chunk"],
                                  max_waiting=sc.get("max_waiting")),
        clock=lambda: now[0], degrade=degrade_mod.DegradeConfig(**deg) if deg else None)
    eng = _FakeEngine(pool_mod, sched, *sc["pool"], bad_decode=sc.get("bad_decode", ()),
                      bad_prefill=sc.get("bad_prefill", ()))
    for uid, (n, new, *dl) in enumerate(sc["reqs"]):
        sched.submit(_FakeReq(uid, n, new, **(dl[0] if dl else {})))
    for tick in range(1, 400):
        now[0] = float(tick)
        if tick in sc.get("cancel", {}):
            assert sched.cancel(sc["cancel"][tick], eng)
        sched.tick(eng)
        if not sched.has_work():
            break
    assert not sched.has_work(), "a request starved"
    return {"done": [(e.uid, e.req.status, e.req.generated) for e in sched.done],
            "metrics": sched.metrics(), "counters": sched.counters_snapshot(),
            "free": eng.pool.num_free, **eng.log}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_matches_reference(name):
    sc = SCENARIOS[name]
    want = _drive(ref_scheduler, ref_degrade, ref_paged, sc)
    got = _drive(scheduler, degrade, paged, sc)
    assert got == want
    assert got["free"] == sc["pool"][0] - 1  # nothing leaked
    if name == "fcfs":
        assert got["first_token"] == sorted(got["first_token"])
    if name == "lifo":
        assert 1 in got["evicted"] and 0 not in got["evicted"]
    if name == "pressure":
        assert got["evicted"] and all(len(d[2]) == 16 for d in got["done"])
    if name == "lifecycle":
        c = got["counters"]
        assert c["shed"] and c["expired"] and c["cancelled"] and c["degraded_prefills"]
        assert c["failed_numeric"] == 2
        assert {g for _, g in got["degraded"]} == {2, 4}


def test_scheduler_requeue_preserves_arrival_order():
    sched = scheduler.Scheduler(scheduler.SchedulerConfig(), clock=lambda: 0.0)
    e0 = scheduler.Entry(req=_FakeReq(0, 4, 4), evicted=True)
    e5 = scheduler.Entry(req=_FakeReq(5, 4, 4))
    sched.waiting.extend([e0, e5])
    sched._requeue(scheduler.Entry(req=_FakeReq(2, 4, 4)))
    assert [e.uid for e in sched.waiting] == [0, 2, 5]


# ---------------------------------------------------------------------------
# The model path: paged step, degraded prefill, engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    return load_reduced_models(ARCH, draw_qkv_bias=False, perms=True)


@pytest.fixture(scope="module")
def arch_models(models):
    """arch → ``models``' tuple for that arch, built on first use."""
    cache = {ARCH: models}

    def get(arch):
        if arch not in cache:
            cache[arch] = load_reduced_models(arch, draw_qkv_bias=arch in QWEN, perms=True)
        return cache[arch]

    return get


# (arch, fused); starcoder2-7b's cases keep their bare ids.
FUSED_IDS = {False: "raw_k", True: "fused_k"}
ARCH_FUSED = ([pytest.param(ARCH, f, id=FUSED_IDS[f]) for f in (False, True)]
              + [pytest.param(a, f, id=f"{a}-{FUSED_IDS[f]}") for a in QWEN
                 for f in (False, True)]
              + [pytest.param(LLAMA4, False, id=f"{LLAMA4}-raw_k"),
                 # distr_decode set: the moe step still pools and reads raw K.
                 pytest.param(LLAMA4, True, id=f"{LLAMA4}-distr_decode")])


def _configs(models, impl, fused):
    rcfg, _, tcfg, _, _ = models
    return tuple(c.replace(attention=replace(c.attention, impl=impl, distr_decode=fused))
                 for c in (rcfg, tcfg))


def _caches(rc, tc, num_blocks, bs):
    return (ref_paged.PagedKVCache(rc, num_blocks, bs, dtype=jnp.float32),
            paged.PagedKVCache(tc, num_blocks, bs, dtype=torch.float32, device="cpu"))


def _assert_pools_equal(rcache, tcache):
    """Every pool but the garbage block, whose content is never read."""
    assert set(tcache.pools) == set(rcache.pools)
    for key, pool in tcache.pools.items():
        np.testing.assert_allclose(pool[:, 1:].numpy(), np.asarray(rcache.pools[key])[:, 1:],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,fused", ARCH_FUSED)
def test_paged_step_matches_reference(arch_models, arch, fused):
    """Chunked prefill of two ragged prompts (12 and 5 tokens, chunks of 8),
    then 8 decode ticks over both lanes; the first request spans 3 blocks."""
    models = arch_models(arch)
    _, rparams, _, tparams, perms = models
    rc, tc = _configs(models, "pallas_distr" if fused else "pallas_flash", fused)
    bs, mb, width = 8, 4, 8
    rng = np.random.default_rng(4)
    streams = rng.integers(0, rc.vocab, size=(2, 20)).astype(np.int32)
    lens = [12, 5]
    rcache, tcache = _caches(rc, tc, 1 + 2 * mb, bs)
    steps = {}
    for w in (width, 1):
        steps[w] = (jax.jit(ref_make_paged_step(rc, w)), make_paged_step(tc, w, perms))

    def run(w, toks, pos, count, uids):
        for c in (rcache, tcache):
            for uid, p in zip(uids, pos):
                c.allocate_to(uid, p + w)
        ref_step, port_step = steps[w]
        r_logits, rcache.pools = ref_step(
            rparams, jnp.asarray(toks), rcache.pools, rcache.table_array(uids, mb),
            jnp.asarray(pos, jnp.int32), jnp.asarray(count, jnp.int32))
        t_logits, _ = port_step(tparams, torch.from_numpy(toks).long(), tcache.pools,
                                tcache.table_array(uids, mb), torch.tensor(pos),
                                torch.tensor(count))
        for row, n in enumerate(count):
            np.testing.assert_allclose(t_logits[row, :n].numpy(),
                                       np.asarray(r_logits)[row, :n], rtol=1e-4, atol=1e-4)

    for uid, n in enumerate(lens):
        for start in range(0, n, width):
            c = min(width, n - start)
            toks = np.zeros((1, width), np.int32)
            toks[0, :c] = streams[uid, start:start + c]
            run(width, toks, [start], [c], [uid])
    for step in range(8):
        pos = [lens[0] + step, lens[1] + step]
        run(1, streams[[0, 1], pos][:, None].copy(), pos, [1, 1], [0, 1])
    assert len(tcache.tables[0]) >= 3 and tcache.tables == rcache.tables
    _assert_pools_equal(rcache, tcache)
    assert ("k" in tcache.pools) == (not fused or tc.family == "moe")


@pytest.mark.parametrize("fused", [False, True], ids=["raw_k", "fused_k"])
def test_degraded_prefill_matches_reference(models, fused):
    """The whole-prompt DistrAttention prefill at G* = 2 into the pool: the
    last live row's logits and the pools; the fused K̂ is written at the
    engine's own G* from the static perms."""
    rcfg, rparams, _, tparams, perms = models
    rc, tc = _configs(models, "pallas_distr", fused)
    n, bucket, bs, mb = 40, 64, 8, 8
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n] = np.random.default_rng(5).integers(0, rc.vocab, size=n)
    rcache, tcache = _caches(rc, tc, 1 + mb, bs)
    for c in (rcache, tcache):
        c.allocate_to(0, n)
    r_row, rcache.pools = jax.jit(ref_degraded_prefill(rc, bucket, 2))(
        rparams, jnp.asarray(toks), jnp.asarray([n], jnp.int32), rcache.pools,
        rcache.table_array([0], mb))
    t_row, _ = make_degraded_paged_prefill(tc, bucket, 2, perms)(
        tparams, torch.from_numpy(toks).long(), n, tcache.pools, tcache.table_array([0], mb))
    np.testing.assert_allclose(t_row.numpy(), np.asarray(r_row), rtol=1e-4, atol=1e-4)
    _assert_pools_equal(rcache, tcache)

    # Layer-0 LSH permutations of this prompt, each package hashing its own
    # f32 queries (the degraded forward's only source of disagreement).
    dcfg = rcfg.attention.distr
    b0 = jax.tree_util.tree_map(lambda p: p[0], rparams["blocks"])
    x = ref_layers.embedding_apply(rparams["embed"], jnp.asarray(toks), jnp.float32)
    h = ref_tf.norm_apply(b0["norm1"], x, rcfg)
    q = ref_attn._split_heads(ref_layers.linear_apply(b0["attn"]["wq"], h), rcfg.n_heads)
    q = ref_layers.apply_rope(q, jnp.arange(bucket)[None], rcfg.rope_theta)
    want = np.asarray(ref_block_perms(q, dcfg))
    p0 = tparams["blocks"][0]
    ht = port_tf.norm_apply(p0["norm1"], port_lm.embed(tparams, tc, torch.from_numpy(toks).long()),
                            tc)
    qt = port_attn._split_heads(port_layers.linear_apply(p0["attn"]["wq"], ht), tc.n_heads)
    qt = port_layers.apply_rope(qt, torch.arange(bucket)[None], tc.rope_theta)
    rate = float((port_block_perms(qt, tc.attention.distr, tparams["lsh_proj"]).numpy()
                  == want).mean())
    print(f"layer-0 degraded-prefill permutation match rate: {rate:.4f}")
    assert rate >= 0.99


# Six requests, one finishing on its prefill token; 8 new tokens grow every
# other request by a block of 8, so a 5-block pool (one whole request of
# max_len 32) forces preemption.
PROMPTS = [list(range(1 + i, 4 + 2 * i)) for i in range(5)] + [[9, 9, 9]]
MAX_NEW = [8] * 5 + [1]
ENGINE = dict(max_batch=3, max_len=32, block_size=8, prefill_chunk=8)


def _serve(eng, prompts, max_new):
    for p, m in zip(prompts, max_new):
        eng.add_request(p, max_new_tokens=m)
    done = eng.run_to_completion(max_steps=300)
    assert all(r.status == "done" for r in done)
    pre = {m["uid"]: m["n_preemptions"] for m in eng.metrics()}
    return {r.uid: r.generated for r in done}, pre


def _engines(models, fused, impl="pallas_flash", **kw):
    _, rparams, _, tparams, perms = models
    rc, tc = _configs(models, impl, fused)
    return (RefPagedEngine(rc, rparams, cache_dtype=jnp.float32, **kw),
            PagedServeEngine(tc, tparams, cache_dtype=torch.float32, device="cpu",
                             perms=perms, **kw))


# (arch, fused, impl); starcoder2-7b's cases keep their bare ids.
ENGINE_CASES = ([pytest.param(ARCH, f, "pallas_flash", id=FUSED_IDS[f]) for f in (False, True)]
                + [pytest.param(a, False, impl, id=f"{a}-raw_k-{impl}") for a in (*QWEN, LLAMA4)
                   for impl in ("pallas_flash", "pallas_distr")])


@pytest.mark.parametrize("arch,fused,impl", ENGINE_CASES)
def test_engine_greedy_tokens_match_reference(arch_models, arch, fused, impl):
    """The six requests on three lanes in a pool with room for all."""
    outs = [_serve(eng, PROMPTS, MAX_NEW)
            for eng in _engines(arch_models(arch), fused, impl, **ENGINE)]
    assert sorted(len(g) for g in outs[1][0].values()) == [1, 8, 8, 8, 8, 8]
    assert outs[1] == outs[0] and not any(outs[1][1].values())


@pytest.mark.parametrize("impl", ["pallas_flash", "pallas_distr"])
@pytest.mark.parametrize("fused", [False, True], ids=["raw_k", "fused_k"])
def test_engine_preemption_and_window_decode_match_reference(models, impl, fused):
    """The same six requests in a 5-block pool: identical tokens and
    preemption counts to the reference, and tokens equal to the roomy run's;
    and a request decoding past the table's capacity (head-block
    recycling); under each kernel impl, over a raw-K and a fused-K̂ pool."""
    (ref_tokens, ref_pre), (tokens, pre) = (
        _serve(eng, PROMPTS, MAX_NEW)
        for eng in _engines(models, fused, impl, num_blocks=5, **ENGINE))
    assert tokens == ref_tokens and pre == ref_pre and sum(pre.values()) > 0
    roomy = _engines(models, fused, impl, **ENGINE)[1]
    assert _serve(roomy, PROMPTS, MAX_NEW)[0] == tokens

    engines = _engines(models, fused, impl, max_batch=2, max_len=16, block_size=8,
                       prefill_chunk=8)
    assert engines[1].capacity_tokens == 16
    outs = [_serve(eng, [[3, 1, 4, 1, 5, 9]], [20]) for eng in engines]
    assert len(outs[1][0][0]) == 20 and outs[1] == outs[0]
    assert engines[1].cache.pool.num_free == engines[1].cache.pool.num_blocks - 1


@pytest.mark.parametrize("impl", ["pallas_flash", "pallas_distr"])
def test_moe_engine_preemption_matches_reference(arch_models, impl):
    """llama4's six requests in a 5-block pool: identical tokens and
    preemption counts to the reference's ``PagedServeEngine``; each chunk
    window's MoE capacity counts its 8 tokens, each tick's its 3 lanes."""
    (ref_tokens, ref_pre), (tokens, pre) = (
        _serve(eng, PROMPTS, MAX_NEW)
        for eng in _engines(arch_models(LLAMA4), False, impl, num_blocks=5, **ENGINE))
    assert tokens == ref_tokens and pre == ref_pre and sum(pre.values()) > 0


def test_mla_is_refused_by_both_paged_engines():
    """MLA keeps the slot engine in both packages: the paged engines, the
    pool layout and the paged step refuse deepseek-v2-236b."""
    from repro.configs import get_config as ref_get_config

    rcfg = ref_get_config("deepseek-v2-236b", reduced=True)
    tcfg = get_config("deepseek-v2-236b", reduced=True)
    with pytest.raises(NotImplementedError, match="use_mla=True"):
        RefPagedEngine(rcfg, {}, max_batch=2, max_len=32)
    with pytest.raises(NotImplementedError, match="use_mla=True"):
        PagedServeEngine(tcfg, {}, max_batch=2, max_len=32, device="cpu")
    for call in (lambda: paged.pool_struct(tcfg, 5, 8), lambda: make_paged_step(tcfg, 1),
                 lambda: make_degraded_paged_prefill(tcfg, 32, 2)):
        with pytest.raises(NotImplementedError, match="GQA dense/moe"):
            call()
