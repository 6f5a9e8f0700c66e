"""Port parity of the explicit collectives, the compressed mean and the
pipeline across a world of processes: one 4-rank gloo world on the CPU
(``launch.mesh.run_world``) runs every case and the test process holds the
results against numpy and the reference.

* the wire layer (``all_reduce``, ``all_gather``, ``reduce_scatter``,
  ``permute``) over each axis of a (data 2, model 2) mesh and over both;
* ``ring_allgather_matmul`` and ``psum_scatter_matmul`` over a 4-rank
  "model" axis against x @ W at the reference's 1e-4, the scatter's slice
  per rank;
* ``ef_pmean`` over a 4-rank "data" axis: equal to the mean of the
  reference's dequantised ``ef_step`` payloads, within the reference's int8
  bound of the exact mean, and its residuals bit-equal to the reference's;
  ``allreduce_with_compression`` with no hook is the plain mean;
* ``shard_params`` / ``gather_params`` round trip, bit for bit, on a
  minicpm-2b ``reduced()`` tree from the reference's weights
  (``from_jax_params``) and on a wide tree that FSDP shards;
* ``pipeline_apply`` over a 4-rank "pod" axis against the stages in
  sequence (the reference's 1e-5), forward and the gradients of every
  stage's params and of x against sequential autograd, and the drain
  ticks: every stage sees each microbatch exactly once (the reference's
  regression test).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 4
S, M, MB, D = 4, 6, 4, 16


def _stage(w, x):
    for layer in w:
        x = torch.tanh(x @ layer)
    return x


def _world_cases(rank, world, arrays):
    """Every case on one rank; rank 0 returns the numbers the test checks,
    the others what differs by rank."""
    torch.set_num_threads(1)
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.pipeline import pipeline_apply, stage_split
    from repro_torch.launch import mesh as hm
    from repro_torch.train.compression import ef_pmean

    t = {k: torch.from_numpy(v) for k, v in arrays.items() if isinstance(v, np.ndarray)}
    out = {}
    dm = hm.make_host_mesh(model_parallel=2)  # (data 2, model 2)
    mine = t["parts"][rank]
    out["reduce_data"] = coll.all_reduce(mine, dm, "data").numpy()
    out["reduce_both"] = coll.all_reduce(mine, dm, ("data", "model")).numpy()
    out["reduce_max"] = coll.all_reduce(mine, dm, "model", op="max").numpy()
    out["reduce_bf16"] = coll.all_reduce(mine.to(torch.bfloat16), dm, "data").float().numpy()
    out["gather_model"] = coll.all_gather(mine, dm, "model", 1).numpy()
    out["gather_both"] = coll.all_gather(mine, dm, ("data", "model"), 0).numpy()
    out["scatter_both"] = coll.reduce_scatter(t["wide"], dm, ("data", "model"), 1).numpy()
    out["permute_model"] = coll.permute(mine, dm, "model", 1).numpy()
    out["coords"] = (dm.coords["data"], dm.coords["model"])

    m4 = hm.make_mesh((world,), ("model",))
    x, w = t["x"], t["w"]
    w_local = shd.local_slice(w, m4, shd.P("model", None))
    out["ring_matmul"] = coll.ring_allgather_matmul(x, w_local, m4).numpy()
    out["scatter_matmul"] = coll.psum_scatter_matmul(x, w_local, m4).numpy()

    d4 = hm.make_mesh((world,), ("data",))
    g = {"a": t["grads"][rank], "b": [t["grads2"][rank]]}
    r = {"a": t["res"][rank], "b": [torch.zeros_like(t["grads2"][rank])]}
    mean, new_r = ef_pmean(g, r, d4, "data")
    out["ef_mean"] = (mean["a"].numpy(), mean["b"][0].numpy())
    out["ef_res"] = new_r["a"].numpy()
    out["plain_mean"] = coll.allreduce_with_compression({"a": g["a"]}, d4)["a"].numpy()

    # Round trips: a reduced model's tree (no FSDP: its dims are under
    # MIN_FSDP_DIM) and a wide tree FSDP shards.
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.convert import from_jax_params

    cfg = get_config("minicpm-2b", reduced=True)
    full = from_jax_params(arrays["ref_params"], cfg, proj=arrays["proj"], device="cpu",
                           dtype=torch.float32)
    specs = shd.param_pspecs(lm.param_axes(cfg), full, dm, fsdp=cfg.fsdp)
    back = shd.gather_params(shd.shard_params(full, dm, specs), dm, specs)
    out["roundtrip_model"] = all(torch.equal(a, b) for a, b in
                                 zip(lm.trainable(full), lm.trainable(back)))
    wide = {"w": t["fsdp_w"], "e": t["fsdp_e"]}
    wspecs = shd.param_pspecs({"w": (None, "mlp"), "e": ("vocab", None)}, wide, dm)
    out["fsdp_specs"] = {k: tuple(v) for k, v in wspecs.items()}
    local = shd.shard_params(wide, dm, wspecs)
    out["fsdp_local_shapes"] = {k: tuple(v.shape) for k, v in local.items()}
    back = shd.gather_params(local, dm, wspecs)
    out["roundtrip_fsdp"] = all(torch.equal(wide[k], back[k]) for k in wide)
    # gather_to: the full leaf on rank 0's host only.
    lead = {k: shd.gather_to(local[k], dm, wspecs[k]) for k in wide}
    out["gather_to"] = (all(torch.equal(wide[k], lead[k])
                            for k in wide) if rank == 0
                        else all(v is None for v in lead.values()))

    # The pipeline.
    p4 = hm.make_mesh((world,), ("pod",))
    stages = stage_split(list(t["ws"]), world)
    stage = int(p4.coords["pod"])
    params = [w.clone().requires_grad_() for w in stages[stage]]
    xs = t["xs"].clone().requires_grad_()
    y = pipeline_apply(_stage, params, xs, p4, axis="pod")
    loss = (y * t["cot"]).sum()
    loss.backward()
    out["pipe_y"] = y.detach().numpy()
    out["pipe_grad_params"] = [p.grad.numpy() for p in params]
    out["pipe_grad_x"] = xs.grad.numpy()

    seen = []

    def record(ws, x):
        seen.append(round(float(x[0, 0]), 3))
        return x

    ident = torch.arange(M, dtype=torch.float32)[:, None, None].expand(M, 2, 8) + 1.0
    with torch.no_grad():
        y_id = pipeline_apply(record, None, ident.contiguous(), p4, axis="pod")
    out["drain_y_err"] = float((y_id - ident).abs().max())
    out["drain_seen"] = seen
    return {"rank": rank, "out": out}


@pytest.fixture(scope="module")
def world():
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.core import lsh as ref_lsh
    from repro.models import lm as ref_lm
    from repro_torch.launch.mesh import run_world

    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    rcfg = ref_get_config("minicpm-2b", reduced=True)
    rparams = jax.tree_util.tree_map(np.asarray, ref_lm.init_params(jax.random.PRNGKey(0), rcfg))
    dcfg = rcfg.attention.distr
    arrays = {"parts": f(WORLD, 3, 4), "wide": f(2, 8), "x": f(8, 64), "w": f(64, 32),
              "grads": f(WORLD, 2, 16), "grads2": f(WORLD, 3, 5) * 10, "res": f(WORLD, 2, 16) * 0.1,
              "fsdp_w": f(2048, 8), "fsdp_e": f(16, 1024),
              "ws": f(8, D, D) * 0.2, "xs": f(M, MB, D), "cot": f(M, MB, D),
              "ref_params": rparams,
              "proj": np.array(ref_lsh.make_projection(jax.random.PRNGKey(dcfg.proj_seed),
                                                       dcfg.block_q))}
    return arrays, run_world(_world_cases, WORLD, arrays, timeout_s=300)


def _by_rank(world, key):
    return [r["out"][key] for r in world[1]]


def test_all_reduce_over_one_axis_and_both(world):
    arrays, results = world
    parts = arrays["parts"]
    for r, res in enumerate(results):
        d, m = res["out"]["coords"]
        assert r == 2 * d + m  # row-major ranks
        same_m = [2 * dd + m for dd in range(2)]
        same_d = [2 * d + mm for mm in range(2)]
        np.testing.assert_allclose(res["out"]["reduce_data"], parts[same_m].sum(0), rtol=1e-6)
        np.testing.assert_allclose(res["out"]["reduce_both"], parts.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(res["out"]["reduce_max"], parts[same_d].max(0))
        bf = torch.from_numpy(parts[same_m]).to(torch.bfloat16).float().sum(0)
        np.testing.assert_array_equal(res["out"]["reduce_bf16"], bf.to(torch.bfloat16).float())


def test_all_gather_reduce_scatter_and_permute(world):
    arrays, results = world
    parts, wide = arrays["parts"], arrays["wide"]
    for r, res in enumerate(results):
        d, m = res["out"]["coords"]
        np.testing.assert_array_equal(res["out"]["gather_model"],
                                      np.concatenate([parts[2 * d], parts[2 * d + 1]], 1))
        np.testing.assert_array_equal(res["out"]["gather_both"], np.concatenate(parts, 0))
        np.testing.assert_allclose(res["out"]["scatter_both"], 4 * wide[:, 2 * r:2 * r + 2],
                                   rtol=1e-6)
        np.testing.assert_array_equal(res["out"]["permute_model"], parts[2 * d + (1 - m)])


def test_ring_allgather_and_psum_scatter_matmul(world):
    """The reference's test: both against x @ W within 1e-4."""
    arrays, results = world
    want = arrays["x"] @ arrays["w"]
    for r, res in enumerate(results):
        assert float(np.abs(res["out"]["ring_matmul"] - want).max()) < 1e-4
        cols = want.shape[1] // WORLD
        got = res["out"]["scatter_matmul"]
        assert got.shape == (want.shape[0], cols)
        assert float(np.abs(got - want[:, r * cols:(r + 1) * cols]).max()) < 1e-4


def test_ef_pmean_against_the_reference(world):
    import jax.numpy as jnp

    from repro.train import compression as ref

    arrays, results = world
    grads, res = arrays["grads"], arrays["res"]
    deq, ref_res = [], []
    for r in range(WORLD):
        (q, s), nr = ref.ef_step(jnp.asarray(grads[r]), jnp.asarray(res[r]))
        deq.append(np.asarray(ref.decompress(q, s)))
        ref_res.append(np.asarray(nr))
    want = np.mean(deq, 0)
    exact = (grads + res).mean(0)
    bound = float(np.abs(grads + res).max()) / 127 + 1e-5
    for r, out in enumerate(results):
        mean_a, mean_b = out["out"]["ef_mean"]
        np.testing.assert_allclose(mean_a, want, rtol=0, atol=1e-6)
        assert float(np.abs(mean_a - exact).max()) < bound
        assert float(np.abs(mean_b - arrays["grads2"].mean(0)).max()) < (
            float(np.abs(arrays["grads2"]).max()) / 127 + 1e-5)
        np.testing.assert_array_equal(out["out"]["ef_res"], ref_res[r])
        np.testing.assert_allclose(out["out"]["plain_mean"], grads.mean(0), rtol=1e-6)


def test_shard_and_gather_round_trip_bit_for_bit(world):
    _, results = world
    for res in results:
        assert res["out"]["roundtrip_model"] and res["out"]["roundtrip_fsdp"]
        assert res["out"]["fsdp_specs"] == {"w": ("data", "model"), "e": ("model", "data")}
        assert res["out"]["fsdp_local_shapes"] == {"w": (1024, 4), "e": (8, 512)}


def test_gather_to_puts_the_full_leaf_on_one_rank_only(world):
    """``sharding.gather_to`` (the mesh checkpoint's gather): rank 0 gets
    every FSDP- and TP-sharded leaf whole and bit for bit, the other ranks
    None."""
    _, results = world
    assert all(res["out"]["gather_to"] for res in results)


def test_pipeline_forward_and_gradients_match_sequential(world):
    arrays, results = world
    ws = torch.from_numpy(arrays["ws"]).requires_grad_()
    xs = torch.from_numpy(arrays["xs"]).requires_grad_()
    want = torch.stack([_stage(ws, mb) for mb in xs])
    (want * torch.from_numpy(arrays["cot"])).sum().backward()
    per = len(arrays["ws"]) // WORLD
    for r, res in enumerate(results):
        out = res["out"]
        assert float(np.abs(out["pipe_y"] - want.detach().numpy()).max()) < 1e-5
        np.testing.assert_allclose(np.stack(out["pipe_grad_params"]),
                                   ws.grad[r * per:(r + 1) * per].numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["pipe_grad_x"], xs.grad.numpy(), rtol=1e-5, atol=1e-6)


def test_pipeline_drain_ticks_inject_zeros(world):
    """Every stage sees each microbatch exactly once: stage 0 injects zeros
    on the drain ticks instead of microbatch M - 1 again."""
    _, results = world
    for res in results:
        out = res["out"]
        assert out["drain_y_err"] < 1e-6
        live = [v for v in out["drain_seen"] if v != 0.0]
        assert sorted(live) == [float(m + 1) for m in range(M)], out["drain_seen"]
        assert len(out["drain_seen"]) == M + S - 1


def test_collectives_refuse_a_group_they_cannot_stage_through(monkeypatch):
    """Any backend but gloo is refused before anything moves, as the ring
    refuses it."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import HostMesh

    mesh = HostMesh(("data",), {"data": 2}, {"data": 0}, {"data": (0, 1)}, {"data": None})
    monkeypatch.setattr(coll.dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(NotImplementedError, match="gloo"):
        coll.all_reduce(torch.ones(2), mesh, "data")
    with pytest.raises(NotImplementedError, match="gloo"):
        coll.permute(torch.ones(2), mesh, "data", 1)
    assert torch.equal(coll.all_gather(torch.ones(2), mesh, "model", 0), torch.ones(2))
