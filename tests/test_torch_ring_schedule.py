"""Port parity on ring context-parallel attention's single-process pieces
(``repro_torch.distributed.ring_attention``, ``repro_torch.launch.mesh``,
``repro_torch.core.api``'s context branch) against the reference's own
functions: the shard length, the block fit, the (O, LSE) merge, the hop
schedule over ring sizes, causal or not, ragged live lengths and dead
shards, and the ring of one that collapses to the single-device op."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.distributed.ring_attention as rra  # noqa: E402
from repro.core import lsh as rl  # noqa: E402
from repro.core.distr_attention import DistrConfig as RefDistrConfig  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.tune.block_sizes import BlockSizes as RefBlockSizes  # noqa: E402
from repro_torch.core.api import AttentionConfig, _active_context_mesh, resolve_attention_blocks  # noqa: E402
from repro_torch.core.distr_attention import DistrConfig  # noqa: E402
from repro_torch.distributed import ring_attention as ra  # noqa: E402
from repro_torch.faults import FaultInjector, FaultSpec  # noqa: E402
from repro_torch.launch import mesh as hm  # noqa: E402


def _fake_mesh(**sizes) -> hm.HostMesh:
    """A mesh object of the given axis sizes for this rank at coordinate 0
    (no process group: for the single-process checks)."""
    axes = tuple(sizes)
    return hm.HostMesh(axes, dict(sizes), dict.fromkeys(axes, 0),
                       {a: tuple(range(s)) for a, s in sizes.items()}, dict.fromkeys(axes))


@pytest.mark.parametrize("n,p,multiple", [
    (1024, 8, 128), (300, 8, 128), (2048, 8, 128), (3000, 8, 128), (3000, 8, 256),
    (300, 4, 128), (8192, 4, 128), (7192, 4, 128), (1, 2, 128), (5000, 3, 384),
])
def test_context_shard_len_matches_reference(n, p, multiple):
    assert ra.context_shard_len(n, p, multiple=multiple) == rra.context_shard_len(
        n, p, multiple=multiple)


@pytest.mark.parametrize("block,shard", [(64, 128), (128, 128), (256, 128), (96, 384),
                                         (100, 300), (512, 1920), (128, 1920)])
def test_fit_block_matches_reference(block, shard):
    assert ra._fit_block(block, shard) == rra._fit_block(block, shard)


def test_merge_partial_algebra_matches_reference():
    """Merging per-shard partials equals the softmax over the concatenated
    KV (the reference test's algebra), and the port's merge equals the
    reference's on the same partials; an empty partial is the identity."""
    rng = np.random.RandomState(0)
    s1, s2 = rng.randn(4, 8) * 3, rng.randn(4, 8) * 3
    v1, v2 = rng.randn(8, 5), rng.randn(8, 5)

    def partial(s, v):
        m = s.max(axis=1, keepdims=True)
        p = np.exp(s - m)
        l = p.sum(axis=1, keepdims=True)
        return ((p @ v) / l).astype(np.float32), (m + np.log(l))[:, 0].astype(np.float32)

    (o1, lse1), (o2, lse2) = partial(s1, v1), partial(s2, v2)
    t = torch.from_numpy
    o, lse = ra._merge_partial(t(o1)[None], t(lse1)[None], t(o2)[None], t(lse2)[None])
    s = np.concatenate([s1, s2], axis=1)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    want = (p / p.sum(axis=1, keepdims=True)) @ np.concatenate([v1, v2], axis=0)
    np.testing.assert_allclose(o[0].numpy(), want, atol=1e-6)
    want_lse = np.log(np.exp(s - s.max(axis=1, keepdims=True)).sum(axis=1)) + s.max(axis=1)
    np.testing.assert_allclose(lse[0].numpy(), want_lse, atol=1e-5)
    ro, rlse = rra._merge_partial(jnp.asarray(o1)[None], jnp.asarray(lse1)[None],
                                  jnp.asarray(o2)[None], jnp.asarray(lse2)[None])
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(rlse), atol=1e-6)
    o_id, _ = ra._merge_partial(torch.zeros(1, 4, 5), torch.full((1, 4), ra.NEG_INF),
                                t(o1)[None], t(lse1)[None])
    np.testing.assert_allclose(o_id[0].numpy(), o1, atol=1e-6)


def _schedules(size, causal, n_live, shard, dead):
    rmeta = rra._RingMeta(axis="context", size=size, causal=causal, scale=1.0,
                          interpret=True, n_live=n_live, shard=shard, blocks=RefBlockSizes())
    mine, ref = [], []
    with ra.dead_shard_fault(dead), rra.dead_shard_fault(dead):
        meta = ra._RingMeta(size=size, causal=causal, scale=1.0, n_live=n_live, shard=shard)
        for idx in range(size):
            for h in range(size):
                src, run, kc = ra._hop_schedule(meta, idx, h)
                rsrc, rrun, rkc = rra._hop_schedule(rmeta, jnp.int32(idx), h)
                mine.append((src, run, kc))
                ref.append((int(rsrc), bool(rrun), bool(rkc)))
    return meta, rmeta, mine, ref


@pytest.mark.parametrize("size", [2, 3, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n_live_shards", ["all", "ragged", "three"])
@pytest.mark.parametrize("dead", [(), (1,), (0, 2)])
def test_hop_schedule_matches_reference(size, causal, n_live_shards, dead):
    """(src, run, kernel_causal) of every hop on every rank, the tail shard
    and the live rows, against the reference's schedule: hop 0 always
    runs (a dead shard's own rank too), the counterpart of the reference's
    dead-shard schedule test."""
    shard = 128
    n_live = {"all": size * shard, "ragged": size * shard - 77,
              "three": min(size, 3) * shard - 84}[n_live_shards]
    meta, rmeta, mine, ref = _schedules(size, causal, n_live, shard, dead)
    assert mine == ref
    assert (meta.tail_idx, meta.tail_len) == (rmeta.tail_idx, rmeta.tail_len)
    for idx in range(size):
        np.testing.assert_array_equal(ra._live_row_mask(meta, idx, shard).numpy(),
                                      np.asarray(rra._live_row_mask(rmeta, jnp.int32(idx),
                                                                    shard)))
        assert mine[idx * size][1] == (idx * shard < n_live)  # hop 0 runs on live ranks
    for idx in range(size):
        for h in range(size):
            src = mine[idx * size + h][0]
            kv_len = ra._hop_kv_variants(meta, src, lambda n: n)
            assert kv_len == (meta.tail_len if src == meta.tail_idx else shard)


def test_hop_counts_at_the_reference_test_length():
    """N = 300 on a ring of 4 (shards of 128, 3 live): 6 causal hops, 9
    non-causal, as the reference's 8-device ring tests count."""
    shard = ra.context_shard_len(300, 4)
    for causal, want in ((True, 6), (False, 9)):
        _, _, mine, _ = _schedules(4, causal, 300, shard, ())
        assert sum(run for _, run, _ in mine) == want


def test_dead_shard_fault_reads_the_catalog_point():
    """``dead_shard_fault`` takes a ``FaultInjector``: the shards of its
    ``dead_ring_shard`` specs die for a ring call begun inside the context,
    hop 0 keeps running, and a call begun after it gets the healthy
    schedule."""
    def meta():
        return ra._RingMeta(size=4, causal=False, scale=1.0, n_live=512, shard=128)

    inj = FaultInjector([FaultSpec("dead_ring_shard", shards=(3,)),
                         FaultSpec("dead_ring_shard", shards=(2,))])
    healthy = [ra._hop_schedule(meta(), 1, h) for h in range(4)]
    with ra.dead_shard_fault(inj):
        inside = meta()
        faulted = [ra._hop_schedule(inside, 1, h) for h in range(4)]
        assert ra._hop_schedule(inside, 3, 0)[1]
    assert inside.dead == {2, 3}
    assert faulted[0] == (1, True, False)
    assert [run for _, run, _ in faulted[1:]] == [src not in (2, 3) for src, _, _ in faulted[1:]]
    assert [ra._hop_schedule(meta(), 1, h) for h in range(4)] == healthy


def test_a_ring_call_keeps_its_dead_shards_after_the_fault_ends():
    """The schedule of a call begun under ``dead_shard_fault`` is the one
    its backward reads, even when the backward runs after the context has
    ended; the hop count is the schedule's."""
    with ra.dead_shard_fault((3,)):
        meta = ra._RingMeta(size=4, causal=False, scale=1.0, n_live=512, shard=128)
        during = [ra._hop_schedule(meta, i, h) for i in range(4) for h in range(4)]
    assert [ra._hop_schedule(meta, i, h) for i in range(4) for h in range(4)] == during
    assert ra._count_hops(meta) == sum(run for _, run, _ in during) == 16 - 3


@pytest.mark.parametrize("backend", ["nccl", "mpi"])
def test_the_ring_refuses_a_group_it_cannot_stage_through(backend, monkeypatch):
    """The ring moves its hops through host memory, which only a gloo
    group takes; any other backend is refused when the ring is set up,
    before any hop."""
    monkeypatch.setattr(ra.dist, "get_backend", lambda group=None: backend)
    with pytest.raises(NotImplementedError, match="gloo"):
        ra._Ring(_fake_mesh(context=4), "context")


def _inputs(rng, b=1, hq=2, hkv=1, n=160, d=32):
    return (rng.standard_normal((b, hq, n, d)).astype(np.float32),
            rng.standard_normal((b, hkv, n, d)).astype(np.float32),
            rng.standard_normal((b, hkv, n, d)).astype(np.float32))


@pytest.mark.parametrize("mesh_kind", ["host", "context1"])
def test_ring_of_one_collapses_to_the_single_device_op(mesh_kind):
    """A ring of one (no context axis, or one of size 1) is the plain
    kernel call, held against the reference's single-device ops in
    interpret mode (the counterpart of the reference's P = 1 test), with
    one hop."""
    mesh = hm.make_host_mesh() if mesh_kind == "host" else hm.make_mesh((1,), ("context",))
    q, k, v = _inputs(np.random.default_rng(0))
    t = torch.from_numpy
    out, hops = ra.ring_flash_attention(t(q), t(k), t(v), mesh, causal=True, return_hops=True)
    ref = rops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    assert hops == 1
    rcfg = RefDistrConfig(group_size=2, block_q=128)
    proj = t(np.array(rl.make_projection(jax.random.PRNGKey(rcfg.proj_seed), 128)))
    outd, hops = ra.ring_distr_attention(t(q), t(k), t(v), DistrConfig(group_size=2, block_q=128),
                                         mesh, causal=True, proj=proj, return_hops=True)
    refd = rops.distr_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rcfg,
                                causal=True)
    np.testing.assert_allclose(outd.numpy(), np.asarray(refd), atol=2e-5, rtol=2e-5)
    assert hops == 1


def test_make_host_mesh_axes_and_divisibility():
    """The reference's axis order, and its divisibility error, over a world
    of one process."""
    mesh = hm.make_host_mesh()
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {"data": 0, "model": 0}
    with pytest.raises(ValueError, match=r"cannot host model_parallel=2 × context_parallel=1"):
        hm.make_host_mesh(model_parallel=2)
    with pytest.raises(ValueError, match=r"need a divisor of the device count"):
        hm.make_host_mesh(context_parallel=4)
    with pytest.raises(ValueError, match="does not cover"):
        hm.make_mesh((2,), ("context",))


def test_set_mesh_nests_and_the_context_mesh_needs_the_axis():
    ring = _fake_mesh(data=1, context=4, model=1)
    one = _fake_mesh(data=1, context=1, model=1)
    assert hm.active_mesh() is None and _active_context_mesh("context") is None
    with hm.set_mesh(ring):
        assert _active_context_mesh("context") is ring
        assert _active_context_mesh(None) is None and _active_context_mesh("seq") is None
        with hm.set_mesh(one):
            assert hm.active_mesh() is one and _active_context_mesh("context") is None
        assert hm.active_mesh() is ring
    assert hm.active_mesh() is None


@pytest.mark.parametrize("wide", [dict(data=2, context=2, model=1),
                                  dict(data=1, context=2, model=2)])
def test_ring_refuses_data_and_model_axes(wide):
    """Data and model axes beside the ring are no longer refused: the caller
    holds its own batch rows and heads, and the ring shards the sequence
    over the context axis alone (the 4-rank runs are in
    ``tests/test_torch_mesh_train.py``).  What the ring still refuses is a
    cross-attention call."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(np.random.default_rng(1), n=512))
    assert ra._ring_size(q, k, _fake_mesh(**wide), "context") == wide["context"]
    with pytest.raises(ValueError, match="self-attention only"):
        ra.ring_flash_attention(q, k[:, :, :256], v[:, :, :256], _fake_mesh(context=2))


def test_resolve_attention_blocks_keys_the_shard_under_a_context_mesh(monkeypatch, tmp_path):
    """Under an active context mesh the tuner's sequence bucket is the
    length one rank streams (``context_shard_len``), as the reference's
    context branch; short or cross-attention calls keep the global N."""
    from repro_torch.tune import autotune

    monkeypatch.setenv("REPRO_TUNE", "analytic")
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "cache.json"))
    autotune.reset_autotuner()
    try:
        cfg = AttentionConfig(impl="pallas_distr", distr=DistrConfig(block_q=None),
                              context_axis="context")
        plain = AttentionConfig(impl="pallas_distr", distr=DistrConfig(block_q=None))
        kw = dict(d=64, dtype="bfloat16", causal=True, device="cpu")
        with hm.set_mesh(_fake_mesh(data=1, context=4, model=1)):
            got = resolve_attention_blocks(cfg, n_q=8192, **kw)
            short = resolve_attention_blocks(cfg, n_q=256, **kw)
            cross = resolve_attention_blocks(cfg, n_q=2048, n_k=8192, **kw)
        assert got == resolve_attention_blocks(plain, n_q=ra.context_shard_len(8192, 4), **kw)
        assert short == resolve_attention_blocks(plain, n_q=256, **kw)
        assert cross == resolve_attention_blocks(plain, n_q=2048, n_k=8192, **kw)
    finally:
        autotune.reset_autotuner()
