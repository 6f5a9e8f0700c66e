"""Port parity of the VLM path (internvl2-2b ``reduced()``: a dense GQA
decoder, 4 query heads over 2 KV heads of 32, RoPE, the patch_stub
frontend with 16 patch tokens, f32) with the reference, on the CPU, from
the same seeded numpy inputs and the reference's weights carried across by
``models.convert.from_jax_params``.  The patches are seeded Gaussian
embeddings, a prefix of the decoder's input; positions run over prefix and
text, and the logits drop the prefix rows.

Held against the reference: ``lm.forward``'s logits with and without
patches under reference, xla_flash and distr (the reference's LSH
projection passed in), to 1e-5 of the logits' scale; the loss, every leaf
of its gradient against ``jax.grad`` and one ``make_train_step`` step at
1e-4; ``make_prefill`` with patches, the cache value for value (1e-5), then
``make_decode_step`` at position S + P (1e-4) and 8 greedy tokens,
identical; the slot engine's greedy tokens on text prompts (no patches, as
the reference's engine serves it) under both kernel impls.  The paged
engine refuses the patch frontend in both packages with the reference's
exception type."""
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

ARCH = "internvl2-2b"
IMPLS = ["reference", "xla_flash", "distr"]
TOL = 1e-4
CACHE_TOL = 1e-5
LOGIT_REL = 1e-5
MAX_LEN = 64
N_PATCH = 16  # num_patch_tokens of reduced()


@pytest.fixture(scope="module")
def models():
    return load_reduced_models(ARCH, draw_qkv_bias=False)


def _with_impl(models, impl):
    rcfg, rparams, tcfg, tparams = models
    return (rcfg.replace(attention=rcfg.attention.with_impl(impl)), rparams,
            tcfg.replace(attention=tcfg.attention.with_impl(impl)), tparams)


def _inputs(seed: int, b: int, n_tok: int, cfg, n_patch: int = N_PATCH):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, n_tok)).astype(np.int32)
    patches = rng.standard_normal((b, n_patch, cfg.d_model)).astype(np.float32)
    return toks, patches


def _rel_close(got, want, rel=LOGIT_REL):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=what)


def test_config_shapes(models):
    _, _, tcfg, tparams = models
    assert tcfg.family == "dense" and tcfg.frontend == "patch_stub" and tcfg.pos == "rope"
    assert tcfg.num_patch_tokens == N_PATCH and tcfg.n_heads // tcfg.n_kv_heads == 2
    assert "pos_embed" not in tparams and "enc_blocks" not in tparams


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(models, impl):
    """With 16 patches before 24 tokens (logits of the 24 text rows), and
    with text alone."""
    rcfg, rparams, tcfg, tparams = _with_impl(models, impl)
    toks, patches = _inputs(1, 2, 24, rcfg)
    rlogits, _ = ref_lm.forward(rparams, rcfg, jnp.asarray(toks), patches=jnp.asarray(patches))
    tlogits = lm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                         patches=torch.from_numpy(patches))
    assert tlogits.shape == (2, 24, tcfg.padded_vocab)
    _rel_close(tlogits, rlogits)
    rlogits, _ = ref_lm.forward(rparams, rcfg, jnp.asarray(toks))
    _rel_close(lm.forward(tparams, tcfg, torch.from_numpy(toks).long()), rlogits)


def test_loss_gradient_and_train_step_match_reference(models):
    """The batch of the reference's smoke test: patches min(16, S // 2) and
    S − P tokens; the loss, every leaf of its gradient against ``jax.grad``,
    then one AdamW step of ``make_train_step`` in each package."""
    rcfg, rparams, tcfg, tparams0 = models
    proj = tparams0["lsh_proj"].numpy()
    toks, patches = _inputs(4, 2, 33, rcfg)
    rb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:]),
          "patches": jnp.asarray(patches)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long(),
          "patches": torch.from_numpy(patches)}

    (rloss, rm), rgrads = jax.jit(jax.value_and_grad(ref_lm.loss_fn, has_aux=True),
                                  static_argnums=1)(rparams, rcfg, rb)
    want = lm.trainable(from_jax_params(jax.tree_util.tree_map(np.asarray, rgrads), tcfg,
                                        proj=proj, device="cpu", dtype=torch.float32))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, rparams), tcfg, proj=proj,
                              device="cpu", dtype=torch.float32)
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


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_with_patches_match_reference(models, impl):
    """Prefill 16 patches and 20 tokens: the cache holds P + S = 36
    positions; then decode at position S + P, as the reference's
    ``tests/test_serve.py`` does."""
    rcfg, rparams, tcfg, tparams = _with_impl(models, impl)
    toks, patches = _inputs(2, 2, 20, rcfg)
    r_logits, r_cache = ref_prefill(rcfg, MAX_LEN)(rparams, jnp.asarray(toks),
                                                    patches=jnp.asarray(patches))
    t_logits, t_cache = make_prefill(tcfg, MAX_LEN)(tparams, torch.from_numpy(toks),
                                                    patches=torch.from_numpy(patches))
    _close(t_logits, r_logits)
    assert set(t_cache) == set(r_cache) == {"k", "v", "length"}
    assert t_cache["length"].tolist() == np.asarray(r_cache["length"]).tolist() == [36, 36]
    for key in ("k", "v"):
        _close(t_cache[key], r_cache[key], CACHE_TOL, what=key)
    nxt = _inputs(3, 2, 1, rcfg)[0]
    pos = np.full((2,), 20 + N_PATCH, np.int32)
    r_logits, r_cache = ref_decode(rcfg)(rparams, jnp.asarray(nxt), r_cache, jnp.asarray(pos))
    t_logits, t_cache = make_decode_step(tcfg)(tparams, torch.from_numpy(nxt), t_cache,
                                               torch.from_numpy(pos))
    _close(t_logits, r_logits)
    for key in ("k", "v"):
        _close(t_cache[key], r_cache[key], CACHE_TOL, what=key)


def _greedy(prefill, decode, params, toks, patches, steps, to_in, to_np):
    logits, cache = prefill(params, to_in(toks), patches=to_in(patches))
    start = toks.shape[1] + patches.shape[1]
    out = []
    nxt = np.argmax(to_np(logits)[:, -1], axis=-1).astype(np.int32)
    for i in range(steps):
        out.append(nxt.tolist())
        pos = np.full((toks.shape[0],), start + i, np.int32)
        logits, cache = decode(params, to_in(nxt[:, None]), cache, to_in(pos))
        nxt = np.argmax(to_np(logits)[:, -1], axis=-1).astype(np.int32)
    return out


@pytest.mark.parametrize("impl", IMPLS)
def test_greedy_tokens_match_reference(models, impl):
    rcfg, rparams, tcfg, tparams = _with_impl(models, impl)
    toks, patches = _inputs(5, 2, 12, rcfg)
    want = _greedy(ref_prefill(rcfg, MAX_LEN), ref_decode(rcfg), rparams, toks, patches, 8,
                   jnp.asarray, np.asarray)
    got = _greedy(make_prefill(tcfg, MAX_LEN), make_decode_step(tcfg), tparams, toks, patches,
                  8, torch.from_numpy, lambda t: t.numpy())
    assert got == want


@pytest.mark.parametrize("impl", ["pallas_distr", "pallas_flash"])
def test_slot_engine_text_prompts_match_reference(models, impl):
    rcfg, rparams, tcfg, tparams = _with_impl(models, impl)
    prompts = ([5, 6, 7], [9, 1, 4, 4, 2, 8, 3, 3, 1, 7, 7], list(range(1, 38)))
    outs = []
    for eng in (RefEngine(rcfg, rparams, max_slots=2, max_len=MAX_LEN),
                ServeEngine(tcfg, tparams, max_slots=2, max_len=MAX_LEN, device="cpu")):
        for p in prompts:
            eng.add_request(list(p), max_new_tokens=6)
        done = eng.run_to_completion()
        outs.append({r.uid: r.generated for r in done})
    assert outs[0] == outs[1]
    assert all(len(g) == 6 for g in outs[1].values())


def test_paged_engine_refuses_the_patch_frontend_in_both_packages(models):
    rcfg, rparams, tcfg, tparams = models
    for make in (lambda: RefPagedEngine(rcfg, rparams, max_batch=2, max_len=MAX_LEN),
                 lambda: PagedServeEngine(tcfg, tparams, max_batch=2, max_len=MAX_LEN,
                                          device="cpu")):
        with pytest.raises(NotImplementedError, match="frontends keep the slot engine"):
            make()
