"""Port parity of tensor-parallel serving on a "model" axis
(``serve/serve_step.py``'s ``make_prefill(mesh=)`` / ``make_decode_step(mesh=)``,
``models/attention.py``'s decode over a sequence-sharded cache,
``models/mamba.py``'s decode on a rank's heads) across one 2-rank gloo world
on the CPU at (data 1, model 2): ``reduced()`` configs in f32 with the
reference's ``init_params(PRNGKey(0))`` weights (``from_jax_params``,
``shard_params`` under ``train_step.mesh_specs``).

For each case the mesh's prefill logits and decode logits (a fixed token
feed) must match the port's one-device steps within 1e-5 (atol and rtol),
and one case a family the reference's steps at ``tests/test_torch_serve.py``'s
1e-4; each rank's cache must be its ``kv_cache.cache_pspecs`` block of the
one device's cache, also within 1e-5:
the dense family under both ``attn_shard`` layouts and both kernel impls,
the fused-K̂ cache (the reference's static perms carried across), a prompt
whose every live position lies on rank 0 (rank 1 merges the identity),
llama4-scout-17b-a16e (MoE), internvl2-2b (a patch prefix), whisper-small
(the cross cache over 48 frames, its positions over "model" too),
mamba2-130m, zamba2-7b and deepseek-v2-236b (MLA's compressed cache by
positions, its absorbed decode merged across the ranks; also with every
decode step past the cache's end).  MLA's absorbed decode is also held
alone in bf16: a whole bf16 model is not, since tensor parallelism in bf16
reroutes the MoE's near-tied tokens.  The reference runs in the test process; the world's ranks
import this module, which imports no JAX at its top.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import one_intra_op_thread  # noqa: E402,F401

WORLD = 2
B, N, S, STEPS, PATCHES, FRAMES = 2, 40, 64, 3, 8, 48
TOL_PORT = 1e-5
TOL_REF = 1e-4
# MLA's absorbed decode alone in bf16 (deepseek-v2's serving dtype), relative
# to the output's largest magnitude, with ``wo`` sliced over "model": each
# rank rounds its partial product to bf16 before the sum, one device rounds
# the whole product once, so the two differ by about one bf16 unit (2^-8).
TOL_BF16_WO = 2.0 ** -7
# (id, arch, attn_shard, impl, distr_decode, prompt length)
CASES = (
    ("dense-seq-flash", "starcoder2-7b", "seq", "pallas_flash", False, N),
    ("dense-heads-flash", "starcoder2-7b", "heads", "pallas_flash", False, N),
    ("dense-seq-distr", "starcoder2-7b", "seq", "pallas_distr", False, N),
    ("dense-heads-distr", "starcoder2-7b", "heads", "pallas_distr", False, N),
    ("dense-seq-fused", "starcoder2-7b", "seq", "pallas_distr", True, N),
    ("dense-heads-fused", "starcoder2-7b", "heads", "pallas_distr", True, N),
    ("dense-seq-one-rank", "starcoder2-7b", "seq", "pallas_flash", False, 20),
    ("moe-seq", "llama4-scout-17b-a16e", "seq", "pallas_flash", False, N),
    ("vlm-seq", "internvl2-2b", "seq", "pallas_flash", False, N),
    ("encdec-seq", "whisper-small", "seq", "pallas_flash", False, N),
    ("ssm", "mamba2-130m", "heads", "pallas_flash", False, N),
    ("hybrid", "zamba2-7b", "heads", "pallas_distr", False, N),
    ("mla", "deepseek-v2-236b", "heads", "pallas_distr", False, N),
    # Every decode step past the cache's end: the write clamps to position
    # S - 1, which lies on rank 1, as a dynamic_update_slice clamps.
    ("mla-past-end", "deepseek-v2-236b", "heads", "pallas_distr", False, S),
)
IDS = [c[0] for c in CASES]


def cfg_of(case):
    import dataclasses

    from repro_torch.configs import get_config

    _, arch, shard, impl, fused, _ = case
    cfg = get_config(arch, reduced=True).replace(attn_shard=shard)
    attn = cfg.attention.with_impl(impl)
    if fused:
        attn = dataclasses.replace(attn, distr_decode=True)
    return cfg.replace(attention=attn)


def _inputs(case, vocab, d_model):
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, vocab, (B, case[5])).astype(np.int32),
           "feed": rng.integers(0, vocab, (STEPS, B, 1)).astype(np.int32)}
    if case[1] == "internvl2-2b":
        out["patches"] = rng.standard_normal((B, PATCHES, d_model)).astype(np.float32)
    if case[1] == "whisper-small":
        out["frames"] = rng.standard_normal((B, FRAMES, d_model)).astype(np.float32)
    return out


def _run(cfg, params, inp, perms, mesh=None):
    """Prefill then STEPS decode steps on the fed tokens → (logits (STEPS +
    1, B, V), the caches after the prefill and after the last step)."""
    from repro_torch.serve.serve_step import make_decode_step, make_prefill

    kw = {k: torch.from_numpy(inp[k]) for k in ("patches", "frames") if k in inp}
    logits, cache = make_prefill(cfg, S, perms=perms, mesh=mesh)(
        params, torch.from_numpy(inp["tokens"]), **kw)
    first = {k: v.clone() for k, v in cache.items()}
    step = make_decode_step(cfg, perms, max_len=S, device="cpu", mesh=mesh)
    out = [logits[:, 0].float().numpy().copy()]
    pos = torch.full((B,), inp["tokens"].shape[1] + (PATCHES if "patches" in kw else 0),
                     dtype=torch.int32)
    for i in range(STEPS):
        logits, cache = step(params, torch.from_numpy(inp["feed"][i]), cache, pos)
        out.append(logits[:, 0].float().numpy().copy())
        pos = pos + 1
    return np.stack(out), first, cache


def _world_cases(rank, world, arrays):
    torch.set_num_threads(1)
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.models.convert import convert_perms, from_jax_params
    from repro_torch.serve import kv_cache
    from repro_torch.train.train_step import mesh_specs

    mesh = make_host_mesh(model_parallel=world)
    out = {}
    for case in CASES:
        cfg = cfg_of(case)
        params = from_jax_params(arrays["ref_params"][case[1]], cfg, proj=arrays["proj"][case[1]],
                                 device="cpu", dtype=lm.compute_dtype(cfg))
        perms = convert_perms(arrays["perms"][case[1]], cfg, "cpu") if case[4] else None
        inp = arrays["inputs"][case[0]]
        one, one_first, one_last = _run(cfg, params, inp, perms)
        local = sharding.shard_params(params, mesh, mesh_specs(cfg, mesh))
        got, first, last = _run(cfg, local, inp, perms, mesh)
        errs = {}
        for label, mine, whole in (("prefill", first, one_first), ("last", last, one_last)):
            want = kv_cache.local_cache(whole, cfg, mesh, batch=B, max_len=S)
            assert set(mine) == set(want), (set(mine), set(want))
            for k in want:
                assert tuple(mine[k].shape) == tuple(want[k].shape), (case[0], k)
                a, w = mine[k].double(), want[k].double()
                # Past allclose's rtol share of the value (0 where within it).
                errs[f"{label}/{k}"] = float(((a - w).abs() - TOL_PORT * w.abs()).clamp(min=0)
                                             .max())
        out[case[0]] = {"mesh": got, "one": one, "cache_err": errs}
    out["mla-bf16-layer"] = _mla_layer_bf16(arrays, mesh)
    return out


def _first_mla(tree):
    """The first MLA block's parameters (the dict holding ``wk_b``) in a
    parameter tree."""
    if isinstance(tree, dict):
        if "wk_b" in tree:
            return tree
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for sub in tree:
            found = _first_mla(sub)
            if found is not None:
                return found
    return None


def _mla_layer_bf16(arrays, mesh):
    """One bf16 ``mla_decode_apply`` of deepseek-v2-236b's first block over
    a seeded cache whose positions lie over "model", beside one device's
    over the whole cache: the weights whole, then sliced by heads.  The
    batch's positions end inside rank 0's half, on its edge, at the cache's
    last position and past it (the write clamps there) → {label: (max
    |mesh - one|, max |one|, the mesh's cache equal to its block of one
    device's)}."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import attention
    from repro_torch.models.convert import from_jax_params
    from repro_torch.serve import kv_cache
    from repro_torch.train.train_step import mesh_specs

    arch = "deepseek-v2-236b"
    cfg = cfg_of(next(c for c in CASES if c[1] == arch)).replace(compute_dtype="bfloat16")
    full = from_jax_params(arrays["ref_params"][arch], cfg, proj=arrays["proj"][arch],
                           device="cpu", dtype=torch.bfloat16)
    sliced = sharding.shard_params(full, mesh, mesh_specs(cfg, mesh))
    rng = np.random.default_rng(11)
    b = 4
    x = torch.from_numpy(rng.standard_normal((b, 1, cfg.d_model), np.float32)).bfloat16()
    ckv = torch.from_numpy(rng.standard_normal((b, S, cfg.kv_lora_rank), np.float32)).bfloat16()
    krope = torch.from_numpy(rng.standard_normal((b, S, cfg.qk_rope_dim), np.float32)).bfloat16()
    pos = torch.tensor([5, S // 2 - 1, S - 1, S + 6], dtype=torch.int32)
    one_ckv, one_krope = ckv.clone(), krope.clone()
    one, _ = attention.mla_decode_apply(_first_mla(full), x, cfg, cache_ckv=one_ckv,
                                        cache_krope=one_krope, cache_index=pos)
    want = kv_cache.local_cache({"ckv": one_ckv[None], "krope": one_krope[None]}, cfg, mesh,
                                batch=b, max_len=S)
    out = {}
    for label, params in (("whole", full), ("sliced", sliced)):
        mine = kv_cache.local_cache({"ckv": ckv[None], "krope": krope[None]}, cfg, mesh,
                                    batch=b, max_len=S)
        mine = {k: v.clone() for k, v in mine.items()}
        with set_mesh(mesh):
            got, _ = attention.mla_decode_apply(_first_mla(params), x, cfg,
                                                cache_ckv=mine["ckv"][0],
                                                cache_krope=mine["krope"][0], cache_index=pos,
                                                layout="seq")
        out[label] = (float((got.float() - one.float()).abs().max()),
                      float(one.float().abs().max()),
                      all(torch.equal(mine[k], want[k]) for k in want))
    return out


@pytest.fixture(scope="module")
def world():
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.core import lsh as ref_lsh
    from repro.models import lm as ref_lm
    from repro.serve import kv_cache as ref_kvc
    from repro_torch.launch.mesh import run_world

    arrays = {"ref_params": {}, "proj": {}, "perms": {}, "inputs": {}}
    for case in CASES:
        arch = case[1]
        rcfg = ref_get_config(arch, reduced=True)
        if arch not in arrays["ref_params"]:
            arrays["ref_params"][arch] = jax.tree_util.tree_map(
                np.asarray, ref_lm.init_params(jax.random.PRNGKey(0), rcfg))
            dcfg = rcfg.attention.distr
            arrays["proj"][arch] = np.array(ref_lsh.make_projection(
                jax.random.PRNGKey(dcfg.proj_seed), dcfg.block_q))
            if rcfg.family == "dense":
                arrays["perms"][arch] = np.asarray(ref_kvc.static_perms(rcfg))
        cfg = cfg_of(case)
        arrays["inputs"][case[0]] = _inputs(case, cfg.vocab, cfg.d_model)
    return arrays, run_world(_world_cases, WORLD, arrays, timeout_s=600)


def _ref_run(arrays, case):
    """The reference's prefill and decode steps on one device, the same
    feed → logits (STEPS + 1, B, V)."""
    import dataclasses

    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.serve.serve_step import make_decode_step, make_prefill

    rcfg = ref_get_config(case[1], reduced=True)
    attn = rcfg.attention.with_impl(case[3])
    if case[4]:
        attn = dataclasses.replace(attn, distr_decode=True)
    rcfg = rcfg.replace(attention=attn)
    params = arrays["ref_params"][case[1]]
    inp = arrays["inputs"][case[0]]
    kw = {k: jnp.asarray(inp[k]) for k in ("patches", "frames") if k in inp}
    logits, cache = make_prefill(rcfg, S)(params, jnp.asarray(inp["tokens"]), **kw)
    out = [np.asarray(logits, np.float32)[:, 0]]
    step = make_decode_step(rcfg)
    pos = jnp.full((B,), inp["tokens"].shape[1] + (PATCHES if "patches" in kw else 0),
                   jnp.int32)
    for i in range(STEPS):
        logits, cache = step(params, jnp.asarray(inp["feed"][i]), cache, pos)
        out.append(np.asarray(logits, np.float32)[:, 0])
        pos = pos + 1
    return np.stack(out)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_serving_matches_one_device(world, case):
    _, results = world
    got = results[0][case[0]]
    np.testing.assert_allclose(got["mesh"], got["one"], atol=TOL_PORT, rtol=TOL_PORT)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_cache_is_its_block_of_one_device(world, case):
    _, results = world
    for rank in range(WORLD):
        errs = results[rank][case[0]]["cache_err"]
        assert max(errs.values()) <= TOL_PORT, (rank, errs)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in
                                  ("dense-seq-fused", "moe-seq", "vlm-seq", "encdec-seq",
                                   "ssm", "hybrid", "mla", "mla-past-end")],
                         ids=lambda c: c[0])
def test_mesh_serving_matches_reference(world, case):
    arrays, results = world
    got = results[0][case[0]]["mesh"]
    want = _ref_run(arrays, case)
    np.testing.assert_allclose(got, want, atol=TOL_REF, rtol=TOL_REF)


def test_one_rank_case_puts_every_live_position_on_rank_0(world):
    """The short prompt's live positions (20 prompt tokens and STEPS decode
    tokens) all lie in rank 0's half of the 64-position cache: rank 1 holds
    nothing but zeros and merges the identity."""
    _, results = world
    assert 20 + STEPS <= S // WORLD
    assert max(results[1]["dense-seq-one-rank"]["cache_err"].values()) == 0.0


def test_mla_decode_in_bf16_matches_one_device(world):
    """In bf16 the mesh's absorbed MLA decode rounds the same normalised
    softmax weights one device does (the max and sum reduced over "model"
    first), and writes a token past the cache's end at its last position:
    with the weights whole the output is bit for bit one device's, with
    them sliced by heads within TOL_BF16_WO of its scale; each rank's cache
    is its block of one device's."""
    _, results = world
    for rank in range(WORLD):
        got = results[rank]["mla-bf16-layer"]
        assert got["whole"][0] == 0.0, (rank, got)
        assert got["sliced"][0] <= TOL_BF16_WO * got["sliced"][1], (rank, got)
        assert got["whole"][2] and got["sliced"][2], (rank, got)
