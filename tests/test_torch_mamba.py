"""Port parity on the ssm and hybrid families: ``ops.ssd`` (the plain path
of the SSD kernel), the Mamba-2 block, the mamba2-130m and zamba2-7b
``reduced()`` forward, prefill and decode steps and the slot engine's greedy
tokens against the JAX package, with the reference's weights carried over by
``models.convert.from_jax_params``.  Inputs are numpy arrays from a seed;
f32 unless a case says bf16.  Also pins the bucket-padding quirk of the SSM
prefill state in both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import lsh as ref_lsh  # noqa: E402
from repro.core.distr_attention import compute_block_permutations as ref_block_perms  # noqa: E402,E501
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve import kv_cache as ref_kv  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serve.serve_step import make_decode_step as ref_decode  # noqa: E402
from repro.serve.serve_step import make_prefill as ref_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.distr_attention import compute_block_permutations as port_block_perms  # noqa: E402,E501
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd as ssd_kernels  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.models import mamba as port_mamba  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import make_decode_step, make_prefill  # noqa: E402

ARCHS = ("mamba2-130m", "zamba2-7b")
# (arch, impl): mamba2-130m is attention-free; zamba2-7b runs its config's
# distr and both kernel impls.
FORWARD_CASES = [("mamba2-130m", None), ("zamba2-7b", None),
                 ("zamba2-7b", "pallas_distr"), ("zamba2-7b", "pallas_flash")]
MAX_LEN = 64
# 32 is a bucket size; 5 and 40 are not; 60 runs into max_len − 2.
PROMPTS = ([5, 6, 7, 1, 2], list(range(1, 33)), [9, 1, 4] * 13 + [2], [3, 8] * 30)
TOL = 1e-4
# The reference's SSD_CASES (tests/test_kernels.py) plus a ragged tail:
# (b, n, h, p, g, s, chunk, dtype).
SSD_CASES = [
    (1, 64, 2, 16, 1, 8, 32, "float32"),
    (2, 128, 4, 32, 2, 16, 32, "float32"),
    (2, 96, 4, 32, 2, 16, 32, "float32"),
    (1, 128, 4, 32, 1, 16, 64, "bfloat16"),
    (2, 70, 4, 16, 2, 8, 32, "float32"),  # ragged: 70 = 2·32 + 6
]


def _ssd_inputs(b, n, h, p, g, s, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, h, p)).astype(np.float32)
    a = -np.logaddexp(rng.standard_normal((b, n, h)), 0).astype(np.float32)
    bm = rng.standard_normal((b, n, g, s)).astype(np.float32)
    c = rng.standard_normal((b, n, g, s)).astype(np.float32)
    return x, a, bm, c


def _jax(arrays, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x, a, bm, c = arrays
    return jnp.asarray(x).astype(jd), jnp.asarray(a), jnp.asarray(bm).astype(jd), \
        jnp.asarray(c).astype(jd)


def _torch(arrays, dtype):
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x, a, bm, c = (torch.from_numpy(t) for t in arrays)
    return x.to(td), a, bm.to(td), c.to(td)


@pytest.mark.parametrize("b,n,h,p,g,s,chunk,dtype", SSD_CASES)
def test_ssd_op_matches_reference_op_and_oracle(b, n, h, p, g, s, chunk, dtype):
    arrays = _ssd_inputs(b, n, h, p, g, s)
    before = ssd_kernels.launches
    got = ops.ssd(*_torch(arrays, dtype), chunk=chunk).float().numpy()
    assert ssd_kernels.launches == before  # CPU tensors take the plain path
    tol = 5e-2 if dtype == "bfloat16" else 2e-3
    want_op = np.asarray(ref_ops.ssd(*_jax(arrays, dtype), chunk=chunk), np.float32)
    want_ref = np.asarray(ref_ref.ssd_ref(*_jax(arrays, dtype)), np.float32)
    assert got.shape == (b, n, h, p)
    np.testing.assert_allclose(got, want_op, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want_ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("b,n,h,p,g,s,chunk,dtype",
                         [c for c in SSD_CASES if c[-1] == "float32"])
def test_ssd_state_matches_ssd_xla(b, n, h, p, g, s, chunk, dtype):
    arrays = _ssd_inputs(b, n, h, p, g, s, seed=4)
    y, state = ops.ssd(*_torch(arrays, dtype), chunk=chunk, return_state=True)
    y_r, state_r = ref_mamba.ssd_xla(*_jax(arrays, dtype), chunk=chunk, return_state=True)
    assert state.dtype == torch.float32 and state.shape == (b, h, s, p)
    np.testing.assert_allclose(state.numpy(), np.asarray(state_r), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=TOL, rtol=TOL)


def test_ssd_plain_selects_past_overflow():
    """Strong decays make exp(a_cum_i − a_cum_j) overflow above the
    diagonal; the plain version selects there, so nothing turns NaN."""
    x, a, bm, c = _ssd_inputs(1, 64, 2, 8, 1, 8, seed=5)
    a = a * 200.0
    y, state = ops.ssd(*_torch((x, a, bm, c), "float32"), chunk=32, return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    want = np.asarray(ref_ref.ssd_ref(*_jax((x, a, bm, c), "float32")))
    np.testing.assert_allclose(y.numpy(), want, atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        rcfg = ref_get_config(arch, reduced=True)
        tcfg = get_config(arch, reduced=True)
        rparams = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
        dcfg = rcfg.attention.distr
        proj = np.array(ref_lsh.make_projection(jax.random.PRNGKey(dcfg.proj_seed),
                                                dcfg.block_q))
        tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, rparams), tcfg,
                                  proj=proj, device="cpu")
        out[arch] = (rcfg, rparams, tcfg, tparams)
    return out


def _with_impl(rcfg, tcfg, impl):
    if impl is None:
        return rcfg, tcfg
    return (rcfg.replace(attention=rcfg.attention.with_impl(impl)),
            tcfg.replace(attention=tcfg.attention.with_impl(impl)))


def _tokens(seed, b, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, n)).astype(np.int32)


def test_configs_match_reference_dims():
    fields = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "head_dim", "tie_embeddings", "ssm_state", "ssm_expand", "ssm_head_dim",
              "ssm_groups", "ssm_conv", "ssm_chunk", "attn_every", "n_shared_attn_blocks",
              "compute_dtype", "d_inner", "ssm_heads", "is_attention_free")
    for arch in ARCHS:
        for reduced in (False, True):
            r, t = ref_get_config(arch, reduced=reduced), get_config(arch, reduced=reduced)
            assert {f: getattr(t, f) for f in fields} == {f: getattr(r, f) for f in fields}
            assert t.attention.impl == r.attention.impl
    zamba = get_config("zamba2-7b")
    assert (zamba.head_dim_, zamba.attention.distr.group_size, zamba.ssm_heads) == (112, 2, 112)


def test_converted_hybrid_params_match_layout(models):
    rcfg, rparams, tcfg, tparams = models["zamba2-7b"]
    n_groups, n_tail = port_lm.hybrid_layout(tcfg)
    assert (n_groups, n_tail) == (2, 1)
    assert [len(g) for g in tparams["groups"]] == [tcfg.attn_every] * n_groups
    assert len(tparams["tail"]) == n_tail and len(tparams["shared"]) == 2
    np.testing.assert_array_equal(
        tparams["groups"][1][0]["mixer"]["in_proj"]["w"].numpy(),
        np.asarray(rparams["groups"]["mixer"]["in_proj"]["w"][1, 0]))
    np.testing.assert_array_equal(tparams["shared"][1]["fuse"]["w"].numpy(),
                                  np.asarray(rparams["shared"][1]["fuse"]["w"]))
    bf16 = from_jax_params(jax.tree_util.tree_map(np.asarray, rparams), tcfg, device="cpu",
                           dtype=torch.bfloat16)
    mixer = bf16["tail"][0]["mixer"]
    assert mixer["in_proj"]["w"].dtype == torch.bfloat16
    for name in ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip"):
        assert mixer[name].dtype == torch.float32, name
    assert mixer["out_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_reference(arch):
    rcfg, tcfg = ref_get_config(arch, reduced=True), get_config(arch, reduced=True)
    want = ref_kv.cache_struct(rcfg, 3, MAX_LEN)
    got = kv_cache.init_cache(tcfg, 3, MAX_LEN, device="cpu")
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        assert tuple(t.shape) == tuple(want[key].shape), key
        assert str(t.dtype).split(".")[-1] == str(want[key].dtype), key


def test_mamba_block_and_decode_steps_match_reference(models):
    rcfg, rparams, tcfg, tparams = models["mamba2-130m"]
    rp = jax.tree_util.tree_map(lambda t: t[0], rparams["blocks"]["mixer"])
    tp = tparams["blocks"][0]["mixer"]
    x = np.random.default_rng(6).standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    out_r, (conv_r, ssm_r) = ref_mamba.mamba_apply(rp, jnp.asarray(x), rcfg, return_state=True)
    out_t, (conv_t, ssm_t) = port_mamba.mamba_apply(tp, torch.from_numpy(x), tcfg,
                                                    return_state=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(conv_t.numpy(), np.asarray(conv_r), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ssm_t.numpy(), np.asarray(ssm_r), atol=TOL, rtol=TOL)
    steps = np.random.default_rng(7).standard_normal((3, 2, 1, tcfg.d_model)).astype(np.float32)
    for xt in steps:
        y_r, (conv_r, ssm_r) = ref_mamba.mamba_decode_apply(
            rp, jnp.asarray(xt), rcfg, conv_state=conv_r, ssm_state=ssm_r)
        y_t, (conv_t, ssm_t) = port_mamba.mamba_decode_apply(
            tp, torch.from_numpy(xt), tcfg, conv_state=conv_t, ssm_state=ssm_t)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(ssm_t.numpy(), np.asarray(ssm_r), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch,impl", FORWARD_CASES)
def test_forward_logits_match_reference(models, arch, impl):
    rcfg, rparams, tcfg, tparams = models[arch]
    rcfg, tcfg = _with_impl(rcfg, tcfg, impl)
    toks = _tokens(1, 2, 40, rcfg.vocab)
    want, _ = ref_lm.forward(rparams, rcfg, jnp.asarray(toks))
    got = port_lm.forward(tparams, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_hybrid_permutation_match_rate(models):
    """The LSH permutations of the first shared block's queries (after two
    Mamba layers and the concat-skip fuse) agree with the reference's."""
    rcfg, rparams, tcfg, tparams = models["zamba2-7b"]
    toks = _tokens(3, 2, 64, rcfg.vocab)
    positions = np.broadcast_to(np.arange(64), (2, 64))

    x = ref_layers.embedding_apply(rparams["embed"], jnp.asarray(toks), jnp.float32)
    h = x
    for li in range(rcfg.attn_every):
        lp = jax.tree_util.tree_map(lambda t, li=li: t[0, li], rparams["groups"])
        h, _, _ = ref_tf.block_apply(lp, h, rcfg, "mamba")
    sp = rparams["shared"][0]
    hf = ref_layers.linear_apply(sp["fuse"], jnp.concatenate([h, x], axis=-1))
    hn = ref_tf.norm_apply(sp["block"]["norm1"], hf, rcfg)
    q = ref_attn._split_heads(ref_layers.linear_apply(sp["block"]["attn"]["wq"], hn),
                              rcfg.n_heads)
    q = ref_layers.apply_rope(q, jnp.asarray(positions), rcfg.rope_theta)
    want = np.asarray(ref_block_perms(q, rcfg.attention.distr))

    xt = port_lm.embed(tparams, tcfg, torch.from_numpy(toks).long())
    ht = xt
    for lp in tparams["groups"][0]:
        ht, _ = port_tf.block_apply(lp, ht, tcfg, layer_type="mamba")
    spt = tparams["shared"][0]
    hft = port_layers.linear_apply(spt["fuse"], torch.cat([ht, xt], dim=-1))
    hnt = port_tf.norm_apply(spt["block"]["norm1"], hft, tcfg)
    qt = port_attn._split_heads(port_layers.linear_apply(spt["block"]["attn"]["wq"], hnt),
                                tcfg.n_heads)
    qt = port_layers.apply_rope(qt, torch.from_numpy(positions.copy()), tcfg.rope_theta)
    got = port_block_perms(qt, tcfg.attention.distr, tparams["lsh_proj"]).numpy()
    rate = float((got == want).mean())
    print(f"zamba2-7b reduced, first shared block: permutation match rate {rate:.4f}")
    assert rate >= 0.99


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(models, arch):
    rcfg, rparams, tcfg, tparams = models[arch]
    rcfg, tcfg = _with_impl(rcfg, tcfg, "pallas_distr" if arch == "zamba2-7b" else None)
    toks = _tokens(2, 2, 40, rcfg.vocab)
    r_logits, r_cache = ref_prefill(rcfg, MAX_LEN)(rparams, jnp.asarray(toks))
    t_logits, t_cache = make_prefill(tcfg, MAX_LEN)(tparams, torch.from_numpy(toks).long())
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits), atol=TOL, rtol=TOL)
    assert sorted(t_cache) == sorted(r_cache)
    for key in t_cache:
        assert tuple(t_cache[key].shape) == r_cache[key].shape, key
        np.testing.assert_allclose(t_cache[key].numpy(), np.asarray(r_cache[key]),
                                   atol=TOL, rtol=TOL, err_msg=key)
    for step in range(3):
        nxt = _tokens(10 + step, 2, 1, rcfg.vocab)
        pos = np.asarray([40 + step, 40 + step], np.int32)
        r_logits, r_cache = ref_decode(rcfg)(rparams, jnp.asarray(nxt), r_cache,
                                             jnp.asarray(pos))
        t_logits, t_cache = make_decode_step(tcfg)(tparams, torch.from_numpy(nxt).long(),
                                                   t_cache, torch.from_numpy(pos))
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits), atol=TOL, rtol=TOL)
        for key in t_cache:
            np.testing.assert_allclose(t_cache[key].numpy(), np.asarray(r_cache[key]),
                                       atol=TOL, rtol=TOL, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_reference(models, arch):
    """Four requests on a 2-slot engine: prompts of a bucket size and not,
    and one that runs into max_len − 2 and stops early (no ring)."""
    rcfg, rparams, tcfg, tparams = models[arch]
    rcfg, tcfg = _with_impl(rcfg, tcfg, "pallas_distr" if arch == "zamba2-7b" else None)
    outs = []
    for eng in (RefEngine(rcfg, rparams, max_slots=2, max_len=MAX_LEN),
                ServeEngine(tcfg, tparams, max_slots=2, max_len=MAX_LEN, device="cpu")):
        for p in PROMPTS:
            eng.add_request(p, max_new_tokens=8)
        done = eng.run_to_completion()
        assert all(r.status == "done" for r in done)
        outs.append({r.uid: r.generated for r in done})
    assert len(outs[1]) == len(PROMPTS)
    assert len(outs[1][3]) == 3  # the 60-token prompt: decodes at pos 60, 61, 62
    assert outs[1] == outs[0]


def test_prefill_state_absorbs_bucket_padding_in_both_packages(models):
    """The slot engine right-pads a prompt with token 0 to its bucket, and the
    SSM state it keeps is the state after the whole bucket: the two packages
    agree on it, and it differs from the unpadded prompt's.  The port's
    engine keeps that padded state in its slot."""
    rcfg, rparams, tcfg, tparams = models["mamba2-130m"]
    prompt = [5, 6, 7, 1, 2]
    padded = np.zeros((1, 32), np.int32)
    padded[0, :5] = prompt
    _, r_cache = ref_prefill(rcfg, MAX_LEN)(rparams, jnp.asarray(padded))
    _, t_cache = make_prefill(tcfg, MAX_LEN)(tparams, torch.from_numpy(padded).long())
    np.testing.assert_allclose(t_cache["ssm"].numpy(), np.asarray(r_cache["ssm"]),
                               atol=TOL, rtol=TOL)
    unpadded = np.asarray([prompt], np.int32)
    _, r_short = ref_prefill(rcfg, MAX_LEN)(rparams, jnp.asarray(unpadded))
    _, t_short = make_prefill(tcfg, MAX_LEN)(tparams, torch.from_numpy(unpadded).long())
    diff_t = float((t_cache["ssm"] - t_short["ssm"]).abs().max())
    diff_r = float(np.abs(np.asarray(r_cache["ssm"]) - np.asarray(r_short["ssm"])).max())
    print(f"SSM state, bucket 32 against the 5-token prompt: max |diff| port {diff_t:.4g}, "
          f"reference {diff_r:.4g} (f32)")
    assert diff_t > 1e-2 and diff_r > 1e-2

    eng = ServeEngine(tcfg, tparams, max_slots=2, max_len=MAX_LEN, device="cpu")
    eng.add_request(prompt, max_new_tokens=1)
    eng._admit([])
    slot = next(iter(eng.active))
    np.testing.assert_allclose(eng.cache["ssm"][:, slot].numpy(), t_cache["ssm"][:, 0].numpy(),
                               atol=0, rtol=0)
