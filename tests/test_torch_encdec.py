"""Port parity of the enc-dec family (whisper-small ``reduced()``: 2 encoder
and 2 decoder layers, MHA 4 × 32, learned positions, layernorm, GELU, f32)
with the reference, on the CPU, from the same seeded numpy inputs and the
reference's weights carried across by ``models.convert.from_jax_params``
(``pos_embed``, ``enc_blocks``, ``enc_norm``, the decoder's ``norm_cross``
and ``cross_attn``).  The stub frontend's frames are seeded Gaussian
embeddings, as the reference's own tests feed them.

Held against the reference: the encoder output and ``lm.forward``'s logits
under reference, xla_flash and distr (the reference's LSH projection passed
in), to 1e-5 of the logits' scale; the loss, every leaf of its gradient
against ``jax.grad`` and one ``make_train_step`` step at 1e-4 (the
reference's f32 tolerance); ``make_prefill`` with frames fewer and more
than ``cross_len`` (the cross cache zero-padded or cut), the whole cache
value for value (1e-5), then ``make_decode_step``'s logits (1e-4) and 8
greedy tokens, identical; ``init_cache``'s layout.  Both engines refuse
enc-dec in both packages with the reference's exception type."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as ref_lm  # noqa: E402
from repro.serve.engine import PagedServeEngine as RefPagedEngine  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serve.serve_step import make_decode_step as ref_decode  # noqa: E402
from repro.serve.serve_step import make_prefill as ref_prefill  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.train_step import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve.engine import PagedServeEngine, ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import make_decode_step, make_prefill  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from _torch_helpers import load_reduced_models, one_intra_op_thread  # noqa: E402,F401

ARCH = "whisper-small"
IMPLS = ["reference", "xla_flash", "distr"]
TOL = 1e-4
CACHE_TOL = 1e-5
LOGIT_REL = 1e-5
MAX_LEN = 48


@pytest.fixture(scope="module")
def models():
    return load_reduced_models(ARCH, draw_qkv_bias=False)


def _with_impl(models, impl):
    rcfg, rparams, tcfg, tparams = models
    return (rcfg.replace(attention=rcfg.attention.with_impl(impl)), rparams,
            tcfg.replace(attention=tcfg.attention.with_impl(impl)), tparams)


def _inputs(seed: int, b: int, n_tok: int, n_frames: int, cfg):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, n_tok)).astype(np.int32)
    frames = rng.standard_normal((b, n_frames, cfg.d_model)).astype(np.float32)
    return toks, frames


def _rel_close(got, want, rel=LOGIT_REL):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=what)


def test_config_shapes(models):
    rcfg, _, tcfg, tparams = models
    assert tcfg.family == "encdec" and tcfg.pos == "learned" and tcfg.frontend == "audio_stub"
    assert (tcfg.n_encoder_layers, tcfg.cross_len, tcfg.learned_pos_len) == (2, 64, 512)
    assert len(tparams["enc_blocks"]) == len(tparams["blocks"]) == 2
    assert tparams["pos_embed"]["table"].shape == (512, tcfg.d_model)
    assert {"norm_cross", "cross_attn"} <= set(tparams["blocks"][0])
    assert not {"norm_cross", "cross_attn"} & set(tparams["enc_blocks"][0])


def test_from_jax_params_carries_the_encdec_tree(models):
    """Every reference leaf has a counterpart, in the port's own init's
    order; in a bf16 conversion the layernorms (``enc_norm``,
    ``norm_cross`` among them) stay f32."""
    rcfg, rparams, tcfg, _ = models
    rnp = jax.tree_util.tree_map(np.asarray, rparams)
    params = from_jax_params(rnp, tcfg, device="cpu", dtype=torch.bfloat16)
    n_ref = sum(x.size for x in jax.tree_util.tree_leaves(rparams))
    assert sum(p.numel() for p in lm.trainable(params)) == n_ref
    names = [n for n, _ in lm.named_trainable(lm.init_params(tcfg, device="cpu"))]
    assert names == [n for n, _ in lm.named_trainable(params)]
    blk = params["blocks"][1]
    assert blk["norm_cross"]["bias"].dtype == params["enc_norm"]["scale"].dtype == torch.float32
    assert blk["cross_attn"]["wk"]["w"].dtype == params["pos_embed"]["table"].dtype \
        == torch.bfloat16
    np.testing.assert_array_equal(
        params["enc_blocks"][1]["attn"]["wq"]["w"].float().numpy(),
        torch.from_numpy(np.array(rnp["enc_blocks"]["attn"]["wq"]["w"][1])).to(
            torch.bfloat16).float().numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_and_forward_match_reference(models, impl):
    rcfg, rparams, tcfg, tparams = _with_impl(models, impl)
    toks, frames = _inputs(1, 2, 24, 40, rcfg)
    want = ref_lm._encode(rparams, rcfg, jnp.asarray(frames))
    got = lm.encode(tparams, tcfg, torch.from_numpy(frames), tparams["lsh_proj"])
    _rel_close(got, want)
    rlogits, _ = ref_lm.forward(rparams, rcfg, jnp.asarray(toks), frames=jnp.asarray(frames))
    tlogits = lm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                         frames=torch.from_numpy(frames))
    assert tlogits.shape == (2, 24, tcfg.padded_vocab)
    _rel_close(tlogits, rlogits)


def test_forward_needs_frames(models):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="frames"):
        lm.forward(tparams, tcfg, torch.zeros((1, 4), dtype=torch.long))


def test_loss_gradient_and_train_step_match_reference(models):
    """The loss (ce, zloss), every leaf of its gradient against
    ``jax.grad`` (the frames carry no gradient), then one AdamW step of
    ``make_train_step`` in each package: loss, grad norm and every
    parameter."""
    rcfg, rparams, tcfg, tparams0 = models
    proj = tparams0["lsh_proj"].numpy()
    toks, frames = _inputs(4, 2, 33, 48, rcfg)
    rb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:]),
          "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long(), "frames": torch.from_numpy(frames)}

    (rloss, rm), rgrads = jax.jit(jax.value_and_grad(ref_lm.loss_fn, has_aux=True),
                                  static_argnums=1)(rparams, rcfg, rb)
    want = lm.trainable(from_jax_params(jax.tree_util.tree_map(np.asarray, rgrads), tcfg,
                                        proj=proj, device="cpu", dtype=torch.float32))
    rnp = jax.tree_util.tree_map(np.asarray, rparams)
    tparams = from_jax_params(rnp, tcfg, proj=proj, device="cpu", dtype=torch.float32)
    leaves = lm.trainable(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss, tm = lm.loss_fn(tparams, tcfg, tb)
    for key in ("ce", "zloss"):
        _close(tm[key], rm[key], what=key)
    _close(loss, rloss)
    loss.backward()
    names = [n for n, _ in lm.named_trainable(tparams)]
    for name, p, g in zip(names, leaves, want):
        _close(p.grad, g.numpy(), what=name)
        p.grad = None
        p.requires_grad_(False)
    # The cross-attention and the encoder take gradient.
    assert float(np.abs(want[names.index("enc_blocks/0/attn/wq/w")].numpy()).max()) > 0
    assert float(np.abs(want[names.index("blocks/1/cross_attn/wk/w")].numpy()).max()) > 0

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


@pytest.mark.parametrize("n_frames", [40, 80], ids=["pad", "cut"])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_cross_cache_and_decode_match_reference(models, impl, n_frames):
    """Prefill 20 tokens over ``n_frames`` frames (cross_len is 64: 40 are
    zero-padded to it, 80 cut to it), the cache value for value, then one
    decode step at position 20: logits and the written cache."""
    rcfg, rparams, tcfg, tparams = _with_impl(models, impl)
    toks, frames = _inputs(2, 2, 20, n_frames, rcfg)
    r_logits, r_cache = ref_prefill(rcfg, MAX_LEN)(rparams, jnp.asarray(toks),
                                                    frames=jnp.asarray(frames))
    t_logits, t_cache = make_prefill(tcfg, MAX_LEN)(tparams, torch.from_numpy(toks),
                                                    frames=torch.from_numpy(frames))
    _close(t_logits, r_logits)
    assert set(t_cache) == set(r_cache) == {"k", "v", "cross_k", "cross_v", "cross_len"}
    for key in ("k", "v", "cross_k", "cross_v"):
        assert t_cache[key].shape == r_cache[key].shape
        _close(t_cache[key], r_cache[key], CACHE_TOL, what=key)
    np.testing.assert_array_equal(t_cache["cross_len"].numpy(), np.asarray(r_cache["cross_len"]))
    assert t_cache["cross_len"].tolist() == [min(n_frames, tcfg.cross_len)] * 2
    if n_frames < tcfg.cross_len:
        assert not t_cache["cross_k"][:, :, :, n_frames:].any()

    nxt = _inputs(3, 2, 1, 1, rcfg)[0]
    pos = np.asarray([20, 20], np.int32)
    r_logits, r_cache = ref_decode(rcfg)(rparams, jnp.asarray(nxt), r_cache, jnp.asarray(pos))
    t_logits, t_cache = make_decode_step(tcfg)(tparams, torch.from_numpy(nxt), t_cache,
                                               torch.from_numpy(pos))
    _close(t_logits, r_logits)
    for key in ("k", "v", "cross_k", "cross_v"):
        _close(t_cache[key], r_cache[key], CACHE_TOL, what=key)


def _greedy(prefill, decode, params, toks, frames, steps, to_in, to_np):
    logits, cache = prefill(params, to_in(toks), frames=to_in(frames))
    out = []
    nxt = np.argmax(to_np(logits)[:, -1], axis=-1).astype(np.int32)
    for i in range(steps):
        out.append(nxt.tolist())
        pos = np.full((toks.shape[0],), toks.shape[1] + i, np.int32)
        logits, cache = decode(params, to_in(nxt[:, None]), cache, to_in(pos))
        nxt = np.argmax(to_np(logits)[:, -1], axis=-1).astype(np.int32)
    return out


@pytest.mark.parametrize("impl", IMPLS)
def test_greedy_tokens_match_reference(models, impl):
    """8 greedy tokens a row after a 12-token prompt over 64 frames."""
    rcfg, rparams, tcfg, tparams = _with_impl(models, impl)
    toks, frames = _inputs(5, 2, 12, 64, rcfg)
    want = _greedy(ref_prefill(rcfg, MAX_LEN), ref_decode(rcfg), rparams, toks, frames, 8,
                   jnp.asarray, np.asarray)
    got = _greedy(make_prefill(tcfg, MAX_LEN), make_decode_step(tcfg), tparams, toks, frames, 8,
                  torch.from_numpy, lambda t: t.numpy())
    assert got == want


def test_init_cache_matches_reference_layout(models):
    """``kv_cache.init_cache``'s enc-dec layout: the reference's keys,
    shapes and dtypes (``cache_struct``), all zero."""
    from repro.serve import kv_cache as ref_kvc
    from repro_torch.serve import kv_cache

    rcfg, _, tcfg, _ = models
    want = ref_kvc.cache_struct(rcfg, 3, MAX_LEN)
    got = kv_cache.init_cache(tcfg, 3, MAX_LEN, device="cpu")
    assert set(got) == set(want) == {"k", "v", "cross_k", "cross_v", "cross_len"}
    for key, t in got.items():
        assert tuple(t.shape) == want[key].shape and not t.any(), key
        assert str(t.dtype).split(".")[-1] == str(want[key].dtype), key


def test_engines_refuse_encdec_in_both_packages(models):
    """The slot engine drives decoder-only archs; the paged engine covers
    GQA dense and moe: both raise NotImplementedError in both packages."""
    rcfg, rparams, tcfg, tparams = models
    for make in (lambda: RefEngine(rcfg, rparams, max_slots=2, max_len=MAX_LEN),
                 lambda: ServeEngine(tcfg, tparams, max_slots=2, max_len=MAX_LEN, device="cpu")):
        with pytest.raises(NotImplementedError, match="serve_step directly"):
            make()
    for make in (lambda: RefPagedEngine(rcfg, rparams, max_batch=2, max_len=MAX_LEN),
                 lambda: PagedServeEngine(tcfg, tparams, max_batch=2, max_len=MAX_LEN,
                                          device="cpu")):
        with pytest.raises(NotImplementedError, match="family='encdec'"):
            make()
