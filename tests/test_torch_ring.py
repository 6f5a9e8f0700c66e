"""Port parity on ring context-parallel attention across a world of
processes: one 4-rank gloo world on the CPU (``launch.mesh.run_world``, a
``FileStore`` under a temporary directory) runs every case; the test
process holds rank 0's outputs and gradients against the reference's
single-device ``ops.flash_attention`` / ``ops.distr_attention`` run as the
JAX tests run them on the CPU (interpret mode), with the reference's LSH
projection passed in, and every rank's results against rank 0's.  The
tolerances are the reference ring tests' (tests/test_distributed.py): f32
2e-5 on O and 5e-5 on the gradients, bf16 2e-2 and 2e-1.  N = 300 on 4
ranks gives shards of 128, 3 of them live: 6 causal hops and 9 non-causal,
as in the reference's tests."""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 4
B, HQ, HKV, N, D = 1, 4, 2, 300, 64
N_RING = 512  # ≥ WORLD × 128: attend dispatches to the ring
TOL = {"f32": (2e-5, 5e-5), "bf16": (2e-2, 2e-1)}
CASES = [(impl, dtype, causal) for impl in ("flash", "distr") for dtype in ("f32", "bf16")
         for causal in (False, True)] + [("distr_shared", "f32", c) for c in (False, True)]
DEAD = (3,)


def _name(impl, dtype, causal):
    return f"{impl}-{dtype}-{'causal' if causal else 'full'}"


def _world_cases(rank, world, arrays):
    """Every case on one rank of the world: outputs, gradients and hop
    counts (rank 0), and a digest of them all (every rank)."""
    torch.set_num_threads(1)
    from repro_torch.core.api import AttentionConfig, attend
    from repro_torch.core.distr_attention import DistrConfig
    from repro_torch.distributed import ring_attention as ra
    from repro_torch.faults import FaultInjector, FaultSpec
    from repro_torch.launch import mesh as hm

    mesh = hm.make_host_mesh(context_parallel=world)
    t = {name: torch.from_numpy(x) for name, x in arrays.items()}
    proj = t["proj"]
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    out = {}

    def run(name, fn, q, k, v, dtype, grads=True):
        q, k, v = (x.to(dtype).requires_grad_(grads) for x in (q, k, v))
        o, hops = fn(q, k, v)
        row = {"hops": hops, "o": o.detach().float().numpy()}
        if grads:
            g = torch.autograd.grad((o.float() * t["w"][:, :, :q.shape[2]]).sum(), (q, k, v))
            row.update(zip(("dq", "dk", "dv"), (x.float().numpy() for x in g)))
        out[name] = row

    for impl, dtype, causal in CASES:
        dcfg = DistrConfig(group_size=2, block_q=128, shared_kv_perm=impl == "distr_shared")

        def fn(q, k, v, impl=impl, causal=causal, dcfg=dcfg):
            if impl == "flash":
                return ra.ring_flash_attention(q, k, v, mesh, causal=causal, return_hops=True)
            return ra.ring_distr_attention(q, k, v, dcfg, mesh, causal=causal, proj=proj,
                                           return_hops=True)

        run(_name(impl, dtype, causal), fn, t["q"], t["k"], t["v"], dtypes[dtype])

    inj = FaultInjector([FaultSpec("dead_ring_shard", shards=DEAD)])
    with ra.dead_shard_fault(inj):
        run("dead", lambda q, k, v: ra.ring_flash_attention(q, k, v, mesh, return_hops=True),
            t["q2"], t["k2"], t["v2"], torch.float32, grads=False)
    # Its gradients, the backward run after the fault has ended: it skips
    # the hops its forward skipped.
    q, k, v = (t[x].clone().requires_grad_() for x in ("q2", "k2", "v2"))
    with ra.dead_shard_fault(inj):
        o = ra.ring_flash_attention(q, k, v, mesh)
    g = torch.autograd.grad((o * t["w"]).sum(), (q, k, v))
    out["dead-grad"] = dict(zip(("dq", "dk", "dv"), (x.numpy() for x in g)))

    # attend: the ring under an active context mesh, the single-device op
    # below WORLD × 128 tokens (ring calls counted).
    calls = []
    real = {name: getattr(ra, name) for name in ("ring_flash_attention", "ring_distr_attention")}
    for name, f in real.items():
        setattr(ra, name, lambda *a, _f=f, _n=name, **kw: (calls.append(_n), _f(*a, **kw))[1])
    try:
        with hm.set_mesh(mesh), torch.no_grad():
            for impl in ("pallas_flash", "pallas_distr"):
                cfg = AttentionConfig(impl=impl, distr=DistrConfig(group_size=2, block_q=128),
                                      context_axis="context")
                for label, n in (("ring", N_RING), ("short", N)):
                    before = len(calls)
                    o = attend(t["q2"][:, :, :n], t["k2"][:, :, :n], t["v2"][:, :, :n], cfg,
                               causal=True, proj=proj)
                    out[f"attend-{impl}-{label}"] = {"o": o.float().numpy(),
                                                     "ring_calls": len(calls) - before}
    finally:
        for name, f in real.items():
            setattr(ra, name, f)

    h = hashlib.sha256()
    for name in sorted(out):
        for key in sorted(out[name]):
            h.update(f"{name}/{key}={out[name][key]!r}".encode() if not isinstance(
                out[name][key], np.ndarray) else out[name][key].tobytes())
    return {"digest": h.hexdigest(), **({"cases": out} if rank == 0 else {})}


@pytest.fixture(scope="module")
def world():
    """The 4-rank world's results, and the inputs it ran on."""
    from repro_torch.launch.mesh import run_world

    import jax

    from repro.core import lsh as rl

    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrays = {"q": f(B, HQ, N, D), "k": f(B, HKV, N, D), "v": f(B, HKV, N, D),
              "w": f(B, HQ, N_RING, D), "q2": f(B, HQ, N_RING, D), "k2": f(B, HKV, N_RING, D),
              "v2": f(B, HKV, N_RING, D),
              "proj": np.array(rl.make_projection(jax.random.PRNGKey(0), 128))}
    results = run_world(_world_cases, WORLD, arrays, timeout_s=300)
    return arrays, results


def _ref(impl, q, k, v, causal):
    from repro.core.distr_attention import DistrConfig as RefDistrConfig
    from repro.kernels import ops as rops

    if impl == "flash":
        return rops.flash_attention(q, k, v, causal=causal)
    cfg = RefDistrConfig(group_size=2, block_q=128, shared_kv_perm=impl == "distr_shared")
    return rops.distr_attention(q, k, v, cfg, causal=causal)


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("impl,dtype,causal", CASES, ids=[_name(*c) for c in CASES])
def test_ring_matches_reference_single_device(world, impl, dtype, causal):
    """Forward and the gradients of q, k and v of the 4-rank ring against
    the reference's single-device op on the same inputs (straight-through
    permutations for distr), and the hop count."""
    import jax
    import jax.numpy as jnp

    arrays, results = world
    row = results[0]["cases"][_name(impl, dtype, causal)]
    assert row["hops"] == (6 if causal else 9)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    q, k, v = (jnp.asarray(arrays[x], jdt) for x in ("q", "k", "v"))
    w = jnp.asarray(arrays["w"][:, :, :N])
    ref, vjp = jax.vjp(lambda q, k, v: _ref(impl, q, k, v, causal).astype(jnp.float32), q, k, v)
    ftol, gtol = TOL[dtype]
    assert _err(row["o"], ref) < ftol
    for name, g in zip(("dq", "dk", "dv"), vjp(w)):
        assert np.isfinite(row[name]).all()
        assert _err(row[name], g) < gtol, name


def test_every_rank_returns_the_same_results(world):
    """Outputs and gradients come out whole and equal, bit for bit, on every
    rank."""
    _, results = world
    assert len({r["digest"] for r in results}) == 1


def test_dead_shard_skips_its_hops_and_stays_finite(world):
    """Shard 3 dead (the ``dead_ring_shard`` catalog point, non-causal, 4
    live shards): its hops to the 3 other ranks are skipped (16 − 3 = 13),
    the output is finite, the live shards' rows equal attention over the
    live keys and the dead shard's own rows equal full attention."""
    import jax.numpy as jnp

    arrays, results = world
    row = results[0]["cases"]["dead"]
    assert row["hops"] == WORLD * WORLD - (WORLD - 1) * len(DEAD)
    assert np.isfinite(row["o"]).all()
    q, k, v = (jnp.asarray(arrays[x]) for x in ("q2", "k2", "v2"))
    live = (WORLD - len(DEAD)) * (N_RING // WORLD)
    ref_live = _ref("flash", q[:, :, :live], k[:, :, :live], v[:, :, :live], False)
    ref_all = _ref("flash", q, k, v, False)
    assert _err(row["o"][:, :, :live], ref_live) < TOL["f32"][0]
    assert _err(row["o"][:, :, live:], np.asarray(ref_all)[:, :, live:]) < TOL["f32"][0]


def test_dead_shard_gradients_follow_its_forward(world):
    """The gradients of q, k and v through the dead-shard ring, its
    backward run after ``dead_shard_fault`` has exited, equal those of the
    degraded output it served (the live shards' rows over the live keys,
    the dead shard's rows over every key) through the reference's ops."""
    import jax
    import jax.numpy as jnp

    arrays, results = world
    row = results[0]["cases"]["dead-grad"]
    live = (WORLD - len(DEAD)) * (N_RING // WORLD)

    def degraded(q, k, v):
        return jnp.concatenate([_ref("flash", q[:, :, :live], k[:, :, :live], v[:, :, :live],
                                     False), _ref("flash", q, k, v, False)[:, :, live:]], axis=2)

    _, vjp = jax.vjp(degraded, *(jnp.asarray(arrays[x]) for x in ("q2", "k2", "v2")))
    for name, g in zip(("dq", "dk", "dv"), vjp(jnp.asarray(arrays["w"]))):
        assert np.isfinite(row[name]).all()
        assert _err(row[name], g) < TOL["f32"][1], name


@pytest.mark.parametrize("impl", ["pallas_flash", "pallas_distr"])
def test_attend_dispatches_to_the_ring_under_a_context_mesh(world, impl):
    """``core.api.attend`` under an active mesh with ``context_axis`` set
    runs the ring for N ≥ 4 × 128 and the single-device op below it, each
    equal to the reference's single-device ``attend``."""
    import jax.numpy as jnp

    from repro.core import AttentionConfig as RefAttentionConfig
    from repro.core import DistrConfig as RefDistrConfig
    from repro.core import attend as ref_attend

    arrays, results = world
    cfg = RefAttentionConfig(impl=impl, distr=RefDistrConfig(group_size=2, block_q=128))
    for label, n, calls in (("ring", N_RING, 1), ("short", N, 0)):
        row = results[0]["cases"][f"attend-{impl}-{label}"]
        assert row["ring_calls"] == calls
        q, k, v = (jnp.asarray(arrays[x][:, :, :n]) for x in ("q2", "k2", "v2"))
        assert _err(row["o"], ref_attend(q, k, v, cfg, causal=True)) < TOL["f32"][0]
