"""Port parity of MLA and the MoE family's model with the reference, on the
CPU in f32 from the same seeded numpy inputs and the reference's weights:
DistrAttention's exact side channel (``q_exact`` / ``k_exact``, d_v ≠ d);
``mla_apply`` under distr, pallas_distr, xla_flash and reference (both
packages take the plain distr path under pallas_distr) and its refusal of
pallas_flash in both; the absorbed ``mla_decode_apply`` over a prefilled
cache; ``lm.forward`` and ``lm.loss_fn`` (ce, aux, zloss) of the reduced
llama4-scout-17b-a16e and deepseek-v2-236b; ``from_jax_params`` over their
trees (``dense_blocks``, stacked experts, the f32 router); and the gradient
of the loss against ``jax.grad``, then one train step of the port's
``make_train_step`` against the reference's.  Tolerance: atol = rtol =
1e-4 (the reference's f32 tolerance), 1e-5 for single ops."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lsh as ref_lsh  # noqa: E402
from repro.core.distr_attention import DistrConfig as RefDistrConfig  # noqa: E402
from repro.core.distr_attention import distr_attention as ref_distr  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.train_step import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.core.distr_attention import DistrConfig, distr_attention  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from _torch_helpers import load_reduced_models, one_intra_op_thread  # noqa: E402,F401

ARCHS = ("llama4-scout-17b-a16e", "deepseek-v2-236b")
DEEPSEEK = "deepseek-v2-236b"
TOL = 1e-4
OP_TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """arch → ``load_reduced_models``' (rcfg, rparams, tcfg, tparams), built
    on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = load_reduced_models(arch, draw_qkv_bias=False)
        return cache[arch]

    return get


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=what)


def _with_impl(rcfg, tcfg, impl):
    return (rcfg.replace(attention=rcfg.attention.with_impl(impl)),
            tcfg.replace(attention=tcfg.attention.with_impl(impl)))


def _layer0(rparams, tparams):
    """Layer 0's attention parameters in both packages (deepseek's dense layer)."""
    rp = jax.tree_util.tree_map(lambda a: a[0], rparams["dense_blocks"]["attn"])
    return rp, tparams["dense_blocks"][0]["attn"]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hkv,n", [(4, 64), (2, 40)], ids=["mha", "gqa_ragged"])
def test_distr_attention_exact_side_channel(hkv, n, causal):
    """q_exact / k_exact scores added exactly before the scale, the masks
    and the softmax; d = 32, d_e = 8, d_v = 16; a ragged N pads q_exact to
    the Q block."""
    rng = np.random.default_rng(0)
    q, k, v = _np(rng, 2, 4, n, 32), _np(rng, 2, hkv, n, 32), _np(rng, 2, hkv, n, 16)
    qe, ke = _np(rng, 2, 4, n, 8), _np(rng, 2, hkv, n, 8)
    proj = np.array(ref_lsh.make_projection(jax.random.PRNGKey(0), 32))
    kw = dict(causal=causal, scale=40 ** -0.5)
    want = ref_distr(*map(jnp.asarray, (q, k, v)), RefDistrConfig(group_size=2, block_q=32,
                                                                  block_k=32),
                     proj=jnp.asarray(proj), q_exact=jnp.asarray(qe), k_exact=jnp.asarray(ke),
                     **kw)
    got = distr_attention(*map(torch.from_numpy, (q, k, v)), DistrConfig(group_size=2,
                                                                         block_q=32),
                          proj=torch.from_numpy(proj), q_exact=torch.from_numpy(qe),
                          k_exact=torch.from_numpy(ke), **kw)
    assert got.shape == (2, 4, n, 16)
    _close(got, want, OP_TOL)


@pytest.mark.parametrize("impl", ["distr", "pallas_distr", "xla_flash", "reference"])
def test_mla_apply_matches_reference(models, impl):
    rcfg, rparams, tcfg, tparams = models(DEEPSEEK)
    rcfg, tcfg = _with_impl(rcfg, tcfg, impl)
    rp, tp = _layer0(rparams, tparams)
    x = _np(np.random.default_rng(1), 2, 40, rcfg.d_model)
    rout, (rckv, rkrope) = ref_attn.mla_apply(rp, jnp.asarray(x), rcfg)
    tout, (tckv, tkrope) = attn.mla_apply(tp, torch.from_numpy(x), tcfg,
                                          proj=tparams["lsh_proj"])
    _close(tout, rout, OP_TOL)
    _close(tckv, rckv, OP_TOL)
    _close(tkrope, rkrope, OP_TOL)


def test_mla_refuses_pallas_flash_in_both_packages(models):
    """The flash kernel needs V as wide as Q (d_qk = 48 against d_v = 32
    here): the reference fails inside its kernel call, the port before any
    launch with a ValueError."""
    rcfg, rparams, tcfg, tparams = models(DEEPSEEK)
    rcfg, tcfg = _with_impl(rcfg, tcfg, "pallas_flash")
    rp, tp = _layer0(rparams, tparams)
    x = _np(np.random.default_rng(1), 1, 32, rcfg.d_model)
    with pytest.raises(TypeError):
        ref_attn.mla_apply(rp, jnp.asarray(x), rcfg)
    with pytest.raises(ValueError, match="pallas_flash"):
        attn.mla_apply(tp, torch.from_numpy(x), tcfg)


def test_mla_decode_matches_reference_over_a_prefilled_cache(models):
    """Prefill 24 positions into a 40-slot cache, then decode one token a
    slot at positions 24 and 20 (the slot at 20 overwrites its cached row
    and attends over positions ≤ 20)."""
    rcfg, rparams, tcfg, tparams = models(DEEPSEEK)
    rp, tp = _layer0(rparams, tparams)
    rng = np.random.default_rng(2)
    x = _np(rng, 2, 24, rcfg.d_model)
    _, (ckv, krope) = ref_attn.mla_apply(rp, jnp.asarray(x), rcfg)
    ckv = np.pad(np.asarray(ckv), ((0, 0), (0, 16), (0, 0)))
    krope = np.pad(np.asarray(krope)[:, 0], ((0, 0), (0, 16), (0, 0)))
    x1 = _np(rng, 2, 1, rcfg.d_model)
    pos = np.asarray([24, 20], np.int32)
    rout, (rckv, rkr) = ref_attn.mla_decode_apply(
        rp, jnp.asarray(x1), rcfg, cache_ckv=jnp.asarray(ckv), cache_krope=jnp.asarray(krope),
        cache_index=jnp.asarray(pos))
    t_ckv, t_kr = torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy())
    tout, (o_ckv, o_kr) = attn.mla_decode_apply(tp, torch.from_numpy(x1), tcfg, cache_ckv=t_ckv,
                                                cache_krope=t_kr, cache_index=torch.from_numpy(pos))
    assert o_ckv is t_ckv and o_kr is t_kr  # written in place
    _close(tout, rout, OP_TOL)
    _close(o_ckv, rckv, OP_TOL)
    _close(o_kr, rkr, OP_TOL)


@pytest.mark.parametrize("impl", ["distr", "xla_flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(models, arch, impl):
    rcfg, rparams, tcfg, tparams = models(arch)
    rcfg, tcfg = _with_impl(rcfg, tcfg, impl)
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (2, 33)).astype(np.int32)
    rlogits, raux = ref_lm.forward(rparams, rcfg, jnp.asarray(toks[:, :-1]))
    tlogits = lm.forward(tparams, tcfg, torch.from_numpy(toks[:, :-1]).long())
    _close(tlogits, rlogits)
    rloss, rm = ref_lm.loss_fn(rparams, rcfg, {"tokens": jnp.asarray(toks[:, :-1]),
                                               "labels": jnp.asarray(toks[:, 1:])})
    tloss, tm = lm.loss_fn(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :-1]).long(),
                                           "labels": torch.from_numpy(toks[:, 1:]).long()})
    assert float(tm["aux"]) > 0  # the MoE layers' router loss
    _close(tm["aux"], raux)
    for key in ("ce", "aux", "zloss"):
        _close(tm[key], rm[key], what=key)
    _close(tloss, rloss)


@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_carries_the_moe_tree(models, arch):
    """Layers unstacked in order (deepseek's dense layer under
    ``dense_blocks``), experts stacked (E, ·, ·) a layer, and in a bf16
    conversion the router, the norms (MLA's q_norm and kv_norm among
    them) kept f32."""
    rcfg, rparams, tcfg, _ = models(arch)
    rnp = jax.tree_util.tree_map(np.asarray, rparams)
    params = from_jax_params(rnp, tcfg, device="cpu", dtype=torch.bfloat16)
    fd = tcfg.first_dense_layers
    assert len(params.get("dense_blocks", [])) == fd
    assert len(params["blocks"]) == tcfg.n_layers - fd
    n_ref = sum(x.size for x in jax.tree_util.tree_leaves(rparams))
    assert sum(p.numel() for p in lm.trainable(params)) == n_ref
    last = params["blocks"][-1]
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff_expert
    assert last["ffn"]["experts"]["gate"].shape == (e, d, f)
    assert last["ffn"]["experts"]["down"].dtype == torch.bfloat16
    router = last["ffn"]["router"]["w"]
    assert router.dtype == torch.float32
    np.testing.assert_array_equal(router.numpy(), rnp["blocks"]["ffn"]["router"]["w"][-1])
    np.testing.assert_array_equal(
        last["ffn"]["experts"]["up"].float().numpy(),
        torch.from_numpy(np.array(rnp["blocks"]["ffn"]["experts"]["up"][-1]))
        .to(torch.bfloat16)
        .float().numpy())
    if tcfg.use_mla:
        a0 = params["dense_blocks"][0]["attn"]
        assert a0["q_norm"]["scale"].dtype == a0["kv_norm"]["scale"].dtype == torch.float32
        assert a0["wkv_a"]["w"].shape == (d, tcfg.kv_lora_rank + tcfg.qk_rope_dim)
        assert params["dense_blocks"][0]["ffn"]["up"]["w"].shape == (d, tcfg.d_ff)
    names = [n for n, _ in lm.named_trainable(lm.init_params(tcfg, device="cpu"))]
    assert names == [n for n, _ in lm.named_trainable(params)]


def _flat_grads(tree) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradient_and_train_step_match_reference(models, arch):
    """Every leaf of the loss's gradient (router aux and z-loss included,
    through the dropped-free capacity of the reduced configs) against
    ``jax.grad``, then one AdamW step of ``make_train_step`` in each
    package: loss, grad norm and every parameter."""
    rcfg, rparams, tcfg, _ = models(arch)
    rnp = jax.tree_util.tree_map(np.asarray, rparams)
    proj = models(arch)[3]["lsh_proj"].numpy()
    toks = np.random.default_rng(4).integers(0, rcfg.vocab, (2, 33)).astype(np.int32)
    rb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}

    rgrads, _ = jax.jit(jax.grad(ref_lm.loss_fn, has_aux=True), static_argnums=1)(
        rparams, rcfg, rb)
    want = lm.trainable(from_jax_params(jax.tree_util.tree_map(np.asarray, rgrads), tcfg,
                                        proj=proj, device="cpu", dtype=torch.float32))
    tparams = from_jax_params(rnp, tcfg, proj=proj, device="cpu", dtype=torch.float32)
    leaves = lm.trainable(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = lm.loss_fn(tparams, tcfg, tb)
    loss.backward()
    names = [n for n, _ in lm.named_trainable(tparams)]
    for name, p, g in zip(names, leaves, want):
        _close(p.grad, g.numpy(), what=name)
        p.grad = None
        p.requires_grad_(False)

    okw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=3, schedule="constant")
    rstep = jax.jit(ref_make_train_step(rcfg, ref_opt.OptimizerConfig(**okw)))
    tstep = make_train_step(tcfg, opt.OptimizerConfig(**okw))
    rnew, _, rm = rstep(rparams, ref_opt.adamw_init(rparams), rb, jnp.asarray(0, jnp.int32))
    tparams, _, tm = tstep(tparams, opt.adamw_init(leaves), tb, 0)
    assert float(tm["skipped"]) == float(rm["skipped"]) == 0.0
    assert float(tm["loss"]) == pytest.approx(float(rm["loss"]), rel=TOL, abs=TOL)
    assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=TOL, abs=TOL)
    want = lm.trainable(from_jax_params(jax.tree_util.tree_map(np.asarray, rnew), tcfg,
                                        proj=proj, device="cpu", dtype=torch.float32))
    for name, got, ref in zip(names, lm.trainable(tparams), want):
        _close(got, ref.numpy(), what=name)
