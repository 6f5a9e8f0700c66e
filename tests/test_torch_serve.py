"""Port parity on the serving path: starcoder2-7b reduced() (2 layers, GQA
4/2, f32) with the reference's lm.init_params(PRNGKey(0)) weights carried
over by models.convert.from_jax_params.  Prefill logits and cache, one
decode step, and the greedy tokens of a 2-slot engine serving 3 requests
match the JAX reference under both kernel impls, and under
``distr_decode`` over the fused-K̂ cache with the reference's static
perms carried across (models.convert.convert_perms).  The prefill, decode
and engine cases also run qwen1.5-4b (MHA 4/4) and qwen2.5-32b (GQA 4/2)
reduced(), both with QKV bias, whose zero-initialised biases are drawn
from a seed in both packages so that they enter before RoPE and the LSH
hash, and the MoE configs' reduced(): llama4-scout-17b-a16e (GQA 4/2, 4
experts top-1 and a shared expert) and deepseek-v2-236b (MLA's compressed
cache, a dense first layer, 8 experts top-2), each MoE layer's capacity set
by the call's tokens: the prefill's bucket, a decode step's slots."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.distr_attention import compute_block_permutations as ref_block_perms  # noqa: E402,E501
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve import kv_cache as ref_kvc  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serve.serve_step import make_decode_step as ref_decode  # noqa: E402
from repro.serve.serve_step import make_prefill as ref_prefill  # noqa: E402
from repro_torch.core.distr_attention import compute_block_permutations as port_block_perms  # noqa: E402,E501
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.models.convert import convert_perms, from_jax_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import make_decode_step, make_prefill  # noqa: E402
from _torch_helpers import load_reduced_models, one_intra_op_thread  # noqa: E402,F401

ARCH = "starcoder2-7b"
QWEN = ("qwen1.5-4b", "qwen2.5-32b")
IMPLS = ["pallas_distr", "pallas_flash"]
# (arch, impl); starcoder2-7b's cases keep their bare impl ids.
# The MoE configs and their impls: MLA runs plain DistrAttention under
# pallas_distr and refuses pallas_flash, so deepseek takes xla_flash.
MOE_IMPLS = [("llama4-scout-17b-a16e", impl) for impl in IMPLS] + [
    ("deepseek-v2-236b", impl) for impl in ("pallas_distr", "xla_flash")]
ARCH_IMPLS = ([pytest.param(ARCH, impl, id=impl) for impl in IMPLS]
              + [pytest.param(a, impl, id=f"{a}-{impl}") for a in QWEN for impl in IMPLS]
              + [pytest.param(a, impl, id=f"{a}-{impl}") for a, impl in MOE_IMPLS])
MAX_LEN = 64
PROMPTS = ([5, 6, 7], [9, 1, 4, 4, 2, 8, 3, 3, 1, 7, 7], list(range(1, 38)))


@pytest.fixture(scope="module")
def models():
    return load_reduced_models(ARCH, draw_qkv_bias=False)


@pytest.fixture(scope="module")
def arch_models(models):
    """arch → ``models``' tuple for that arch, built on first use."""
    cache = {ARCH: models}

    def get(arch):
        if arch not in cache:
            cache[arch] = load_reduced_models(arch, draw_qkv_bias=arch in QWEN)
        return cache[arch]

    return get


def _with_impl(rcfg, tcfg, impl):
    return (rcfg.replace(attention=rcfg.attention.with_impl(impl)),
            tcfg.replace(attention=tcfg.attention.with_impl(impl)))


def _tokens(seed, b, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, n)).astype(np.int32)


def test_converted_params_match_layout(models):
    rcfg, rparams, tcfg, tparams = models
    assert len(tparams["blocks"]) == tcfg.n_layers
    np.testing.assert_array_equal(tparams["blocks"][1]["attn"]["wq"]["w"].numpy(),
                                  np.asarray(rparams["blocks"]["attn"]["wq"]["w"][1]))
    assert tparams["final_norm"]["scale"].dtype == torch.float32
    assert tparams["lsh_proj"].shape == (16, tcfg.attention.distr.block_q)


@pytest.mark.parametrize("arch,impl", ARCH_IMPLS)
def test_prefill_and_decode_step_match_reference(arch_models, arch, impl):
    rcfg, rparams, tcfg, tparams = arch_models(arch)
    rcfg, tcfg = _with_impl(rcfg, tcfg, impl)
    toks = _tokens(1, 2, 40, rcfg.vocab)
    r_logits, r_cache = ref_prefill(rcfg, MAX_LEN)(rparams, jnp.asarray(toks))
    t_logits, t_cache = make_prefill(tcfg, MAX_LEN)(tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits), atol=1e-4, rtol=1e-4)
    # GQA: k, v and length; MLA: ckv and krope.
    assert set(t_cache) == set(r_cache)
    for key in set(t_cache) - {"length"}:
        assert t_cache[key].shape == r_cache[key].shape
        np.testing.assert_allclose(t_cache[key].numpy(), np.asarray(r_cache[key]),
                                   atol=1e-4, rtol=1e-4)
    if "length" in r_cache:
        np.testing.assert_array_equal(t_cache["length"].numpy(), np.asarray(r_cache["length"]))

    nxt = _tokens(2, 2, 1, rcfg.vocab)
    pos = np.asarray([40, 40], np.int32)
    r_logits, r_cache = ref_decode(rcfg)(rparams, jnp.asarray(nxt), r_cache, jnp.asarray(pos))
    t_logits, t_cache = make_decode_step(tcfg)(tparams, torch.from_numpy(nxt), t_cache,
                                               torch.from_numpy(pos))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits), atol=1e-4, rtol=1e-4)
    for key in set(t_cache) - {"length"}:
        np.testing.assert_allclose(t_cache[key].numpy(), np.asarray(r_cache[key]),
                                   atol=1e-4, rtol=1e-4)


def test_prefill_permutation_match_rate(models):
    """The layer-0 LSH permutations of a real prefill agree with the
    reference's (each package hashes its own f32 queries)."""
    rcfg, rparams, tcfg, tparams = models
    toks = _tokens(3, 2, 64, rcfg.vocab)
    dcfg = rcfg.attention.distr
    b0 = jax.tree_util.tree_map(lambda p: p[0], rparams["blocks"])
    x = ref_layers.embedding_apply(rparams["embed"], jnp.asarray(toks), jnp.float32)
    h = ref_tf.norm_apply(b0["norm1"], x, rcfg)
    q = ref_attn._split_heads(ref_layers.linear_apply(b0["attn"]["wq"], h), rcfg.n_heads)
    q = ref_layers.apply_rope(q, jnp.broadcast_to(jnp.arange(64), (2, 64)), rcfg.rope_theta)
    want = np.asarray(ref_block_perms(q, dcfg))

    p0 = tparams["blocks"][0]
    xt = port_lm.embed(tparams, tcfg, torch.from_numpy(toks).long())
    ht = port_tf.norm_apply(p0["norm1"], xt, tcfg)
    qt = port_attn._split_heads(port_layers.linear_apply(p0["attn"]["wq"], ht), tcfg.n_heads)
    qt = port_layers.apply_rope(qt, torch.arange(64).expand(2, 64), tcfg.rope_theta)
    got = port_block_perms(qt, tcfg.attention.distr, tparams["lsh_proj"]).numpy()
    rate = float((got == want).mean())
    print(f"layer-0 prefill permutation match rate: {rate:.4f}")
    assert rate >= 0.99


@pytest.mark.parametrize("arch,impl", ARCH_IMPLS)
def test_engine_greedy_tokens_match_reference(arch_models, arch, impl):
    """Three requests on a 2-slot engine (more requests than slots)."""
    rcfg, rparams, tcfg, tparams = arch_models(arch)
    rcfg, tcfg = _with_impl(rcfg, tcfg, impl)
    outs = []
    for eng in (RefEngine(rcfg, rparams, max_slots=2, max_len=MAX_LEN),
                ServeEngine(tcfg, tparams, max_slots=2, max_len=MAX_LEN, device="cpu")):
        for p in PROMPTS:
            eng.add_request(p, max_new_tokens=4)
        done = eng.run_to_completion()
        assert all(r.status == "done" for r in done)
        outs.append({r.uid: r.generated for r in done})
    assert len(outs[1]) == len(PROMPTS)
    assert outs[1] == outs[0]


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "deepseek-v2-236b"])
def test_moe_engine_capacity_counts_the_bucket(arch_models, arch, monkeypatch):
    """Capacity factor 1: a prefill of T = 32 or 64 bucket tokens drops
    assignments, the pad tokens (id 0) queueing behind the prompt, and a
    decode step's capacity counts both slots.  The greedy tokens equal the
    reference engine's."""
    from repro_torch.models import moe

    rcfg, rparams, tcfg, tparams = arch_models(arch)
    rcfg, tcfg = (c.replace(capacity_factor=1.0) for c in (rcfg, tcfg))
    calls = []  # (tokens of the call, assignments dropped) of the port's MoE calls
    dispatch = moe._dispatch_index

    def counted(params, xf, weights, ids, cfg):
        cap = moe.capacity(cfg, xf.shape[0])
        calls.append((xf.shape[0], int((moe.queue_ranks(ids, cfg.n_experts) >= cap).sum())))
        return dispatch(params, xf, weights, ids, cfg)

    monkeypatch.setattr(moe, "_dispatch_index", counted)
    outs = []
    for eng in (RefEngine(rcfg, rparams, max_slots=2, max_len=MAX_LEN),
                ServeEngine(tcfg, tparams, max_slots=2, max_len=MAX_LEN, device="cpu")):
        for p in PROMPTS:
            eng.add_request(p, max_new_tokens=6)
        done = eng.run_to_completion()
        assert all(r.status == "done" for r in done)
        outs.append({r.uid: r.generated for r in done})
    assert sorted(len(g) for g in outs[1].values()) == [6, 6, 6]
    assert outs[1] == outs[0]
    assert {t for t, _ in calls} == {32, 64, 2}  # two buckets, a step's two slots
    assert sum(d for t, d in calls if t > 2) > 0 and sum(d for t, d in calls if t == 2) == 0


@pytest.mark.parametrize("impl", ["reference", *IMPLS])
def test_engine_sliding_window_past_max_len_matches_reference(models, impl):
    """Two requests on a 2-slot engine of max_len 32 generating 40 tokens
    each, so both caches wrap their ring (the sliding window past
    max_len): the greedy tokens match the reference engine's."""
    rcfg, rparams, tcfg, tparams = models
    rcfg, tcfg = _with_impl(rcfg, tcfg, impl)
    prompts = (list(range(3, 23)), [4, 8, 15, 16, 23, 42, 7, 1])
    outs = []
    for eng in (RefEngine(rcfg, rparams, max_slots=2, max_len=32),
                ServeEngine(tcfg, tparams, max_slots=2, max_len=32, device="cpu")):
        for p in prompts:
            eng.add_request(p, max_new_tokens=40)
        done = eng.run_to_completion()
        assert all(r.status == "done" for r in done)
        outs.append({r.uid: r.generated for r in done})
    assert sorted(len(g) for g in outs[1].values()) == [40, 40]
    assert outs[1] == outs[0]


def _fused(rcfg, tcfg):
    """Both configs under pallas_distr with the fused-K̂ decode cache."""
    return tuple(c.replace(attention=replace(c.attention, impl="pallas_distr",
                                             distr_decode=True)) for c in (rcfg, tcfg))


def test_fused_prefill_and_decode_step_match_reference(models):
    """The fused-K̂ slot cache: the prefill writes ``k_fused`` (d/G* wide)
    beside k, v and length; one decode step reads it (raw K stays as the
    prefill left it) and its logits and cache match the reference's."""
    rcfg, rparams, tcfg, tparams = models
    rcfg, tcfg = _fused(rcfg, tcfg)
    perms = convert_perms(np.asarray(ref_kvc.static_perms(rcfg)), tcfg, "cpu")
    toks = _tokens(1, 2, 40, rcfg.vocab)
    r_logits, r_cache = ref_prefill(rcfg, MAX_LEN)(rparams, jnp.asarray(toks))
    t_logits, t_cache = make_prefill(tcfg, MAX_LEN, perms=perms)(tparams, torch.from_numpy(toks))
    assert set(t_cache) == set(r_cache) == {"k", "k_fused", "length", "v"}
    assert t_cache["k_fused"].shape[-1] == tcfg.head_dim_ // tcfg.attention.distr.group_size
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits), atol=1e-4, rtol=1e-4)
    for key in ("k", "k_fused", "v"):
        assert t_cache[key].shape == r_cache[key].shape
        np.testing.assert_allclose(t_cache[key].numpy(), np.asarray(r_cache[key]),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(t_cache["length"].numpy(), np.asarray(r_cache["length"]))

    k_before = t_cache["k"].clone()
    nxt = _tokens(2, 2, 1, rcfg.vocab)
    pos = np.asarray([40, 40], np.int32)
    r_logits, r_cache = ref_decode(rcfg)(rparams, jnp.asarray(nxt), r_cache, jnp.asarray(pos))
    t_logits, t_cache = make_decode_step(tcfg, perms)(tparams, torch.from_numpy(nxt), t_cache,
                                                      torch.from_numpy(pos))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits), atol=1e-4, rtol=1e-4)
    for key in ("k_fused", "v"):
        np.testing.assert_allclose(t_cache[key].numpy(), np.asarray(r_cache[key]),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(t_cache["length"].numpy(), np.asarray(r_cache["length"]))
    assert torch.equal(t_cache["k"], k_before)  # raw K is not written at decode


@pytest.mark.parametrize("max_len", [MAX_LEN, 32], ids=["roomy", "sliding"])
def test_fused_engine_greedy_tokens_match_reference(models, max_len):
    """The 2-slot engines under ``distr_decode`` decode from the fused-K̂
    cache: the same greedy tokens as the reference engine's, also with
    the ring sliding past max_len."""
    rcfg, rparams, tcfg, tparams = models
    rcfg, tcfg = _fused(rcfg, tcfg)
    perms = convert_perms(np.asarray(ref_kvc.static_perms(rcfg)), tcfg, "cpu")
    prompts, new = (PROMPTS, 4) if max_len == MAX_LEN else (PROMPTS[:2], 30)
    outs, engines = [], (RefEngine(rcfg, rparams, max_slots=2, max_len=max_len),
                         ServeEngine(tcfg, tparams, max_slots=2, max_len=max_len, device="cpu",
                                     perms=perms))
    for eng in engines:
        for p in prompts:
            eng.add_request(p, max_new_tokens=new)
        done = eng.run_to_completion()
        assert all(r.status == "done" for r in done)
        outs.append({r.uid: r.generated for r in done})
    assert engines[1].cache["k_fused"].shape[-1] == tcfg.head_dim_ // 2
    assert sorted(len(g) for g in outs[1].values()) == [new] * len(prompts)
    assert outs[1] == outs[0]
