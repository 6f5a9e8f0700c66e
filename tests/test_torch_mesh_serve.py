"""Port parity of serving over a context mesh (``ServeEngine(mesh=)``,
``PagedServeEngine(mesh=)``, ``serve_step.make_mesh_paged_prefill``, the
scheduler's mesh admission and ``serve/mesh_prefill.py``'s leader and
follower) across one 2-rank gloo world on the CPU
(``launch.mesh.run_world``), as the reference's
``tests/test_distributed.py`` serves over a ring of 2.

qwen1.5-4b ``reduced()`` with the reference's weights carried across,
``context_axis="context"``, a 300-token prompt (bucket 512 ≥ 2 × 128: the
ring takes every layer's attention), ``max_len`` 512, an f32 cache, blocks
of 128 and chunks of 32.  Rank 0 leads (the engines), rank 1 follows
(``mesh_prefill.follow``):

* under ``pallas_flash`` and ``pallas_distr`` (their plain versions on the
  CPU) both mesh engines' greedy tokens and counters equal the reference's
  on one device: its slot engine with no mesh, and its paged engine over a
  context mesh of one device (its mesh admission; the ring's one-device
  case, which is the same function); under ``pallas_flash`` the paged
  one's also equal the reference's paged engine with no mesh (chunked);
* the paged mesh engine counts one ``mesh_prefill``, the prompt spans
  three blocks, no block leaks, and the pool's first layer K/V equal, bit
  for bit, what the same prefill writes on one rank with no mesh (the later
  layers within 1e-5);
* the cluster router steers the prompt to the mesh replica and away from a
  64-token one, and the emitted tokens equal the reference's;
* a ``dead_ring_shard`` fault travels in the header: every rank launches
  the hops ``distributed.ring_attention._hop_schedule`` gives for that dead
  set (and without it, the full causal schedule), and each follower ran
  every prefill its leader announced;
* a follower whose leader sends nothing raises ``TimeoutError`` within its
  time limit.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import load_reduced_models, one_intra_op_thread  # noqa: E402,F401

ARCH = "qwen1.5-4b"
WORLD = 2
N_PROMPT, MAX_LEN, NEW = 300, 512, 4
PAGED = dict(max_batch=2, max_len=MAX_LEN, block_size=128, prefill_chunk=32)
IMPLS = ("pallas_flash", "pallas_distr")
DEAD = (0,)
HANDOFF_TOL = 1e-5
FOLLOW_TIMEOUT = 1.0


def _mesh_cfg(cfg, impl, axis="context"):
    from dataclasses import replace

    return cfg.replace(attention=replace(cfg.attention, impl=impl, context_axis=axis))


def _port(arrays):
    from repro_torch.configs import get_config
    from repro_torch.models.convert import from_jax_params

    cfg = get_config(ARCH, reduced=True)
    return cfg, from_jax_params(arrays["params"], cfg, proj=arrays["proj"], device="cpu")


def _world_cases(rank, world, arrays):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.distributed import ring_attention as ra
    from repro_torch.faults import FaultInjector, FaultSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.cluster import ClusterRouter
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine
    from repro_torch.serve.mesh_prefill import follow, leader_link
    from repro_torch.serve.serve_step import make_mesh_paged_prefill

    mesh = make_mesh((world,), ("context",))
    base, params = _port(arrays)
    prompt = arrays["prompt"]
    lead = rank == 0
    hops = {"n": 0}
    real_call = ra.flash_attention_kernel_call

    def counted(*a, **kw):
        hops["n"] += 1
        return real_call(*a, **kw)

    ra.flash_attention_kernel_call = counted

    def serve(make, cfg, *, routed=None):
        """Rank 0 builds the engine and serves the prompt; rank 1 follows.
        Returns (what the run reports, this rank's flash launches)."""
        hops["n"] = 0
        if not lead:
            return follow(cfg, params, mesh, max_len=MAX_LEN, device="cpu", timeout_s=120), \
                hops["n"]
        with make(cfg) as eng:
            out = routed(eng) if routed else _serve_one(eng, prompt)
        out["sent"] = eng._link.sent
        return out, hops["n"]

    out = {}
    for impl in IMPLS:
        cfg = _mesh_cfg(base, impl)
        out["slot", impl] = serve(lambda c: ServeEngine(
            c, params, max_slots=2, max_len=MAX_LEN, device="cpu", mesh=mesh), cfg)
        out["paged", impl] = serve(lambda c: PagedServeEngine(
            c, params, cache_dtype=torch.float32, device="cpu", mesh=mesh, **PAGED), cfg,
            routed=lambda eng: _handoff(eng, prompt, make_mesh_paged_prefill, params))

    cfg = _mesh_cfg(base, "pallas_flash")

    def route(eng):
        short = PagedServeEngine(_mesh_cfg(base, "pallas_flash", None), params,
                                 cache_dtype=torch.float32, device="cpu", max_batch=2,
                                 max_len=64, block_size=64, prefill_chunk=32)
        router = ClusterRouter([short, eng], policy="round_robin")
        uid = router.add_request(prompt, max_new_tokens=NEW)
        rid = router.request(uid).rid
        router.run_to_completion(max_ticks=600)
        creq = router.request(uid)
        return {"rid": rid, "status": creq.status, "emitted": list(creq.emitted),
                "max_prompt_len": [short.max_prompt_len, eng.max_prompt_len]}

    out["routed"] = serve(lambda c: PagedServeEngine(
        c, params, cache_dtype=torch.float32, device="cpu", mesh=mesh, **PAGED), cfg,
        routed=route)
    dead = FaultInjector([FaultSpec("dead_ring_shard", shards=DEAD)])
    out["dead"] = serve(lambda c: PagedServeEngine(
        c, params, cache_dtype=torch.float32, device="cpu", mesh=mesh, faults=dead,
        **PAGED), cfg)
    ra.flash_attention_kernel_call = real_call

    # A follower whose leader sends nothing raises within its limit; the
    # leader's late stop header then completes the broadcast left pending.
    if lead:
        time.sleep(3 * FOLLOW_TIMEOUT)
        leader_link(cfg, mesh, MAX_LEN).close()
    else:
        t0 = time.monotonic()
        try:
            follow(cfg, params, mesh, max_len=MAX_LEN, device="cpu", timeout_s=FOLLOW_TIMEOUT)
        except TimeoutError as e:
            out["timeout"] = (str(e), time.monotonic() - t0)
    dist.barrier()
    return out


def _serve_one(eng, prompt):
    eng.add_request(prompt, max_new_tokens=NEW)
    done = eng.run_to_completion(max_steps=200)
    return {"tokens": done[0].generated, "status": done[0].status,
            "counters": eng.counters_snapshot()}


def _handoff(eng, prompt, make_mesh_paged_prefill, params):
    """Serve the prompt on the paged mesh engine, reading its pool after the
    admitting tick (the prompt's K/V, before any decode token overwrites
    past it) beside the same prefill on this rank with no mesh."""
    from repro_torch.serve import paged

    free0 = eng.cache.pool.num_free
    eng.add_request(prompt, max_new_tokens=NEW)
    eng.step()
    uid = next(iter(eng.scheduler.running.values())).uid
    table = eng.cache.tables[uid]
    one = paged.PagedKVCache(eng.cfg, eng.cache.pool.num_blocks, eng.block_size,
                             dtype=torch.float32, device="cpu")
    one.allocate_to(uid, N_PROMPT)
    bucket = 512
    toks = torch.tensor([list(prompt) + [0] * (bucket - N_PROMPT)])
    with torch.no_grad():
        make_mesh_paged_prefill(eng.cfg, bucket)(params, toks, N_PROMPT, one.pools,
                                              one.table_array([uid], eng.max_blocks))

    def rows(pools, blocks):
        return torch.cat([pools["k"][:, b] for b in blocks], dim=2)[:, :, :N_PROMPT], \
            torch.cat([pools["v"][:, b] for b in blocks], dim=2)[:, :, :N_PROMPT]

    (k, v), (k1, v1) = rows(eng.cache.pools, table), rows(one.pools, one.tables[uid])
    first_equal = bool(torch.equal(k[0], k1[0]) and torch.equal(v[0], v1[0]))
    later = max(float((k[1:] - k1[1:]).abs().max()), float((v[1:] - v1[1:]).abs().max()))
    done = eng.run_to_completion(max_steps=200)
    return {"tokens": done[0].generated, "status": done[0].status,
            "counters": eng.counters_snapshot(), "blocks": len(table),
            "leaked": free0 - eng.cache.pool.num_free, "first_layer_equal": first_equal,
            "later_layers_err": later}


def _reference_runs(rcfg, rparams, prompt):
    """The reference's engines on one device under both impls: the slot
    engine with no mesh, and the paged engine over a context mesh of one
    device (its mesh admission, the ring's single-device case); and its
    paged engine with no mesh (chunked prefill) under pallas_flash →
    {(engine, impl): (tokens, counters)}."""
    from dataclasses import replace

    import jax.numpy as jnp

    from repro.launch.mesh import compat_make_mesh
    from repro.serve.engine import PagedServeEngine as RefPaged
    from repro.serve.engine import ServeEngine as RefServe

    def run(eng):
        eng.add_request(prompt, max_new_tokens=NEW)
        return eng.run_to_completion()[0].generated, eng.counters_snapshot()

    one = compat_make_mesh((1,), ("context",))
    out = {}
    for impl in IMPLS:
        c = rcfg.replace(attention=replace(rcfg.attention, impl=impl, context_axis="context"))
        out["slot", impl] = run(RefServe(c, rparams, max_slots=2, max_len=MAX_LEN))
        out["paged", impl] = run(RefPaged(c, rparams, cache_dtype=jnp.float32, mesh=one,
                                          **PAGED))
    c = rcfg.replace(attention=rcfg.attention.with_impl("pallas_flash"))
    out["chunked", "pallas_flash"] = run(RefPaged(c, rparams, cache_dtype=jnp.float32, **PAGED))
    return out


@pytest.fixture(scope="module")
def world():
    import jax

    from repro_torch.launch.mesh import run_world

    rcfg, rparams, _, _ = load_reduced_models(ARCH, draw_qkv_bias=True)
    prompt = [int(t) for t in np.random.RandomState(0).randint(0, rcfg.vocab, size=N_PROMPT)]
    from repro.core import lsh as ref_lsh

    dcfg = rcfg.attention.distr
    arrays = {"params": jax.tree_util.tree_map(np.asarray, rparams), "prompt": prompt,
              "proj": np.array(ref_lsh.make_projection(jax.random.PRNGKey(dcfg.proj_seed),
                                                       dcfg.block_q))}
    results = run_world(_world_cases, WORLD, arrays, timeout_s=600)
    yield results, _reference_runs(rcfg, rparams, prompt)


@pytest.mark.parametrize("engine", ["slot", "paged"])
@pytest.mark.parametrize("impl", IMPLS)
def test_mesh_engines_match_the_reference_greedy_tokens(world, engine, impl):
    results, ref = world
    got, _ = results[0][engine, impl]
    assert got["status"] == "done"
    tokens, counters = ref[engine, impl]
    assert got["tokens"] == tokens
    assert got["counters"] == counters
    if impl == "pallas_flash" and engine == "paged":
        assert got["tokens"] == ref["chunked", impl][0]


@pytest.mark.parametrize("impl", IMPLS)
def test_paged_mesh_prefill_counters_blocks_and_handoff(world, impl):
    results, _ = world
    got, _ = results[0]["paged", impl]
    assert got["counters"]["mesh_prefills"] == 1
    assert got["blocks"] >= 3 and got["leaked"] == 0
    assert got["first_layer_equal"]
    assert got["later_layers_err"] < HANDOFF_TOL
    slot, _ = results[0]["slot", impl]
    assert slot["counters"]["mesh_prefills"] == 0  # the slot engine has no such admission


def test_router_steers_the_long_prompt_to_the_mesh_replica(world):
    results, ref = world
    got, _ = results[0]["routed"]
    assert got["max_prompt_len"][0] < N_PROMPT <= got["max_prompt_len"][1]
    assert got["rid"] == 1, "the long prompt missed the mesh replica"
    assert got["status"] == "done"
    assert got["emitted"] == ref["chunked", "pallas_flash"][0]


def test_followers_run_every_announced_prefill(world):
    results, _ = world
    for key, (lead, _) in results[0].items():
        follower, _ = results[1][key]
        assert lead["sent"] == 1 and follower["prefills"] == 1, key
        assert follower["buckets"] == [512]


def test_dead_shard_travels_in_the_header(world):
    from repro_torch.distributed import ring_attention as ra
    from repro_torch.configs import get_config

    results, _ = world
    n_layers = get_config(ARCH, reduced=True).n_layers
    shard = ra.context_shard_len(512, WORLD)

    def want(rank, dead):
        meta = ra._RingMeta(size=WORLD, causal=True, scale=1.0, n_live=512, shard=shard,
                            dead=frozenset(dead))
        return n_layers * sum(ra._hop_schedule(meta, rank, h)[1] for h in range(WORLD))

    for rank in range(WORLD):
        _, hops = results[rank]["dead"]
        assert hops == want(rank, DEAD), rank
        _, full = results[rank]["paged", "pallas_flash"]
        assert full == want(rank, ())
    assert results[1]["dead"][0]["dead"] == [list(DEAD)]
    assert results[0]["dead"][0]["status"] == "done"
    assert want(1, DEAD) < want(1, ())  # the dead shard's hop was skipped


def test_follower_raises_when_no_header_comes(world):
    results, _ = world
    text, waited = results[1]["timeout"]
    assert "no header" in text
    assert FOLLOW_TIMEOUT <= waited < 3 * FOLLOW_TIMEOUT
