"""Port parity of the "seq" layout (``models/attention.py::_attention_seq``,
``distributed/ring_attention.py::ring_attention_shard``): under
``attn_shard="seq"`` on a "model" axis, a training or prefill self-attention
over N ≥ model × 128 positions shards its sequence over "model", each rank
projecting and attending its own positions over a ring on that axis.

One 2-rank gloo world on the CPU at (data 1, model 2) and one 4-rank world
at (data 1, model 4), ``reduced()`` configs in f32 with the reference's
``init_params(PRNGKey(0))`` weights (``from_jax_params``, QKV biases drawn)
and LSH projection.  Cases: N = 256 and N = 300 (the last shard padded),
``pallas_flash`` and ``pallas_distr``, a head count that "model" cuts (6
query and 3 KV heads of 32: ``wk`` and ``wv`` sliced through a head, as
qwen2.5-32b's are at 16), whisper-small's non-causal encoder (256 frames)
under its causal decoder, N = 40, below the guard, which takes the
"heads" / "gather" path as before, and on four ranks N = 520 (rank 2 holds
8 live rows, rank 3 none).  For each:

* the layer (layer 0's attention on a drawn input): each rank's output and
  (k, v) shard against the reference's single-device ``attention_apply`` at
  TOL_REF, and against the port's one device with the gradients of
  ``sum(out · c)`` (x and every weight, this rank's slice) at TOL_PORT; the
  layer also runs with its weights held whole;
* one training step (AdamW swapped for ``p -= g``): loss, grad norm and every
  leaf's clipped gradient against the port's one device at TOL_PORT and the
  reference's ``jax.grad`` at TOL_REF;
* a prefill into a 512- or 1024-position cache: the logits against one device's and
  each rank's cache its ``kv_cache.cache_pspecs`` block of one device's, at
  TOL_PORT;
* on the "seq" path no weight is gathered (``attention.gathered`` is never
  called) and the ring calls the kernel wrappers: the forward (flash or
  DistrAttention) and, in training, delta, dq and dkv;
* a planted fault, each rank's shard offset by one position after the
  all-to-all, which the layer's, the step's and the prefill's gates catch.

The reference runs in the test process; the world's ranks import this
module, which imports no JAX at its top.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import one_intra_op_thread  # noqa: E402,F401

WORLDS = (2, 4)
B = 2
TOL_PORT = 1e-5
TOL_REF = 1e-4
# (case, arch, impl, N, (heads, KV heads, head dim) or None, encoder frames,
# "model" ranks)
CASES = (
    ("flash-256", "starcoder2-7b", "pallas_flash", 256, None, 0, 2),
    ("distr-256", "starcoder2-7b", "pallas_distr", 256, None, 0, 2),
    ("flash-300", "starcoder2-7b", "pallas_flash", 300, None, 0, 2),
    ("distr-300", "starcoder2-7b", "pallas_distr", 300, None, 0, 2),
    ("cut-heads", "qwen2.5-32b", "pallas_distr", 300, (6, 3, 32), 0, 2),
    ("encoder", "whisper-small", "pallas_distr", 256, None, 256, 2),
    ("short", "qwen2.5-32b", "pallas_distr", 40, (6, 3, 32), 0, 2),
    # Four ranks of 256 rows: rank 2 holds 8 live rows, rank 3 none; wk and
    # wv sliced through a head.
    ("flash-520-model4", "starcoder2-7b", "pallas_flash", 520, None, 0, 4),
    ("distr-520-model4", "starcoder2-7b", "pallas_distr", 520, None, 0, 4),
)
IDS = [c[0] for c in CASES]
BY_ID = {c[0]: c for c in CASES}
SEQ_IDS = [c[0] for c in CASES if c[3] >= c[6] * 128]
# The layer run with its weights held whole (not sliced over "model").
WHOLE = "flash-300"
# The case the planted fault runs in (every weight sliced: both exchanges).
FAULTED = "cut-heads"
RING_CALLS = ("fwd", "delta", "dq", "dkv")


def configs(case):
    """(the reference's config, the port's) of a case, in f32 under its
    kernel impl."""
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config

    _, arch, impl, _, heads, _, _ = case
    out = []
    for get in (ref_get_config, get_config):
        cfg = get(arch, reduced=True)
        if heads:
            cfg = cfg.replace(n_heads=heads[0], n_kv_heads=heads[1], head_dim=heads[2])
        out.append(cfg.replace(attention=cfg.attention.with_impl(impl)))
    return out


def port_cfg(case):
    from repro_torch.configs import get_config

    _, arch, impl, _, heads, _, _ = case
    cfg = get_config(arch, reduced=True)
    if heads:
        cfg = cfg.replace(n_heads=heads[0], n_kv_heads=heads[1], head_dim=heads[2])
    return cfg.replace(attention=cfg.attention.with_impl(impl))


def port_params(case, arrays):
    from repro_torch.models import lm
    from repro_torch.models.convert import from_jax_params

    cfg = port_cfg(case)
    return cfg, from_jax_params(arrays["ref_params"][case[0]], cfg, proj=arrays["proj"],
                                device="cpu", dtype=lm.param_dtype(cfg))


def max_len(case) -> int:
    """The prefill cache's positions: a multiple of the ranks past N."""
    return 512 if case[3] <= 512 else 1024


def _mesh_of(case, rank: int = 0):
    """A dry stand-in for the case's (data 1, model) mesh at ``rank``."""
    from repro_torch.launch.mesh import dry_mesh

    return dry_mesh((1, case[6]), ("data", "model"), rank)


def _shard(case) -> int:
    """The rows a rank holds under the "seq" layout."""
    from repro_torch.distributed.ring_attention import shard_len

    return shard_len(port_cfg(case).attention, case[3], case[6], d=port_cfg(case).head_dim_,
                     dtype=torch.float32, causal=not case[5], device="cpu")


def _layer_key(case) -> str:
    return "enc_blocks" if case[5] else "blocks"


def _layer(params: dict, case) -> dict:
    return params[_layer_key(case)][0]["attn"]


def _fresh(tree):
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad.detach().numpy().copy()


def run_layer(case, arrays, mesh=None, spec=None):
    """Layer 0's attention on the case's input → {out, k, v, x grad, the
    weights' grads (this rank's slices under ``spec``, else whole)} as
    numpy."""
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import attention

    cfg, params = port_params(case, arrays)
    lp = _layer(params, case)
    if spec is not None:
        from repro_torch.distributed import sharding

        lp = sharding.shard_params(lp, mesh, spec)
    lp = _fresh(lp)
    x = torch.from_numpy(arrays["x"][case[0]]).requires_grad_(True)
    with set_mesh(mesh):
        out, (k, v) = attention.attention_apply(lp, x, cfg, causal=not case[5],
                                                proj=params["lsh_proj"])
        (out * torch.from_numpy(arrays["c"][case[0]])).sum().backward()
    return {"out": out.detach().numpy().copy(), "k": k.detach().numpy().copy(),
            "v": v.detach().numpy().copy(), "dx": x.grad.numpy().copy(), "dw": _grads(lp)}


def _sgd(params, grads, state, opt_cfg, lr):
    """AdamW swapped for p -= g: the parameters then carry the clipped
    gradient."""
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(g.float())
    state["count"] += 1
    return params, state


def _batch(case, arrays):
    return {k: torch.from_numpy(v) for k, v in arrays["batch"][case[0]].items()}


def run_step(case, arrays, mesh=None):
    """One train step from the case's weights with AdamW swapped for p -= g
    → (loss, grad norm, the clipped gradient of every trainable leaf,
    whole, as numpy)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg, params = port_params(case, arrays)
    before = {n: t.detach().numpy().copy() for n, t in lm.named_trainable(params)}
    if mesh is not None:
        specs = ts.mesh_specs(cfg, mesh)
        params = sharding.shard_params(params, mesh, specs)
    real = opt.adamw_update
    opt.adamw_update = _sgd
    try:
        state = opt.adamw_init(lm.trainable(params))
        ocfg = opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10)
        params, _, m = ts.make_train_step(cfg, ocfg, mesh)(params, state, _batch(case, arrays), 0)
    finally:
        opt.adamw_update = real
    if mesh is not None:
        params = sharding.gather_params(params, mesh, specs)
    grads = {n: before[n] - t.detach().numpy() for n, t in lm.named_trainable(params)}
    return float(m["loss"]), float(m["grad_norm"]), grads


def run_prefill(case, arrays, mesh=None):
    """A prefill of the case's tokens (frames too) into a ``max_len`` cache →
    (last-position logits, the cache), as numpy; on a mesh the cache is this
    rank's block."""
    from repro_torch.distributed import sharding
    from repro_torch.serve.serve_step import make_prefill
    from repro_torch.train.train_step import mesh_specs

    cfg, params = port_params(case, arrays)
    if mesh is not None:
        params = sharding.shard_params(params, mesh, mesh_specs(cfg, mesh))
    batch = _batch(case, arrays)
    kw = {"frames": batch["frames"]} if "frames" in batch else {}
    logits, cache = make_prefill(cfg, max_len(case), mesh=mesh)(params, batch["tokens"], **kw)
    return logits.numpy().copy(), {k: v.numpy().copy() for k, v in cache.items()}


class _Spy:
    """Counts the calls to the ring's kernel wrappers and to
    ``attention.gathered`` while active."""

    def __init__(self):
        from repro_torch.distributed import ring_attention as ring
        from repro_torch.kernels import backward as bwd
        from repro_torch.models import attention

        self.counts = dict.fromkeys(RING_CALLS + ("gathered",), 0)
        self.sites = [(ring, "flash_attention_kernel_call", "fwd"),
                      (ring, "distr_attention_kernel_call", "fwd"),
                      (bwd, "delta_kernel_call", "delta"),
                      (bwd, "flash_dq_kernel_call", "dq"), (bwd, "distr_dq_kernel_call", "dq"),
                      (bwd, "flash_dkv_kernel_call", "dkv"),
                      (bwd, "distr_dkv_kernel_call", "dkv"),
                      (attention, "gathered", "gathered")]
        self.real = []

    def __enter__(self):
        for obj, name, key in self.sites:
            fn = getattr(obj, name)
            self.real.append((obj, name, fn))

            def counted(*a, _fn=fn, _key=key, **k):
                self.counts[_key] += 1
                return _fn(*a, **k)

            setattr(obj, name, counted)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.real:
            setattr(obj, name, fn)


def _offset_by_one(real):
    """The planted fault: each rank's shard offset by one position after
    the all-to-all that takes the projections to positions."""
    def wrong(t, mesh, shard):
        return torch.roll(real(t, mesh, shard), 1, dims=1)
    return wrong


def _world_cases(rank, world, arrays):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention
    from repro_torch.train.train_step import mesh_specs

    mesh = make_host_mesh(model_parallel=world)
    out = {}
    for case in (c for c in CASES if c[6] == world):
        spec = mesh_specs(port_cfg(case), mesh)[_layer_key(case)][0]["attn"]
        got = {}
        with _Spy() as spy:
            got["layer"] = run_layer(case, arrays, mesh, spec)
            got["layer_calls"] = dict(spy.counts)
        with _Spy() as spy:
            got["step"] = run_step(case, arrays, mesh)
            got["step_calls"] = dict(spy.counts)
        with _Spy() as spy:
            got["prefill"] = run_prefill(case, arrays, mesh)
            got["prefill_calls"] = dict(spy.counts)
        if case[0] == WHOLE:
            got["whole"] = run_layer(case, arrays, mesh)
        if case[0] == FAULTED:
            real = attention._cols_to_rows
            attention._cols_to_rows = _offset_by_one(real)
            try:
                got["faulted"] = {"layer": run_layer(case, arrays, mesh, spec),
                                  "step": run_step(case, arrays, mesh),
                                  "prefill": run_prefill(case, arrays, mesh)}
            finally:
                attention._cols_to_rows = real
        out[case[0]] = got
    return out


def _draw_ref(case, rng):
    """The reference's weights for a case (QKV biases drawn) and its
    inputs, as numpy."""
    import jax

    from _torch_helpers import with_drawn_qkv_bias
    from repro.models import lm as ref_lm

    rcfg, cfg = configs(case)
    rparams = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    if rcfg.qkv_bias:
        rparams = with_drawn_qkv_bias(rparams)
    n = case[3]
    toks = rng.integers(0, cfg.vocab, (B, n + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if case[5]:
        batch["frames"] = rng.standard_normal((B, case[5], cfg.d_model)).astype(np.float32)
    n_x = case[5] or n
    return (jax.tree_util.tree_map(np.asarray, rparams), batch,
            rng.standard_normal((B, n_x, cfg.d_model)).astype(np.float32),
            rng.standard_normal((B, n_x, cfg.d_model)).astype(np.float32))


@pytest.fixture(scope="module")
def world():
    import jax

    from repro.core import lsh as ref_lsh
    from repro_torch.launch.mesh import run_world

    rng = np.random.default_rng(0)
    arrays = {"ref_params": {}, "batch": {}, "x": {}, "c": {}}
    for case in CASES:
        (arrays["ref_params"][case[0]], arrays["batch"][case[0]], arrays["x"][case[0]],
         arrays["c"][case[0]]) = _draw_ref(case, rng)
    dcfg = configs(CASES[0])[0].attention.distr
    arrays["proj"] = np.array(ref_lsh.make_projection(jax.random.PRNGKey(dcfg.proj_seed),
                                                      dcfg.block_q))
    return arrays, {w: run_world(_world_cases, w, arrays, timeout_s=600) for w in WORLDS}


@pytest.fixture(scope="module")
def one_device(world):
    """The port's one-device layer, step and prefill of every case."""
    arrays, _ = world
    out = {}
    for case in CASES:
        out[case[0]] = {"layer": run_layer(case, arrays), "step": run_step(case, arrays),
                        "prefill": run_prefill(case, arrays)}
    return out


def _excess(got, want, tol) -> float:
    """How far ``got`` lies past ``tol + tol · |want|`` (0 within it)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want) - tol - tol * np.abs(want), initial=0.0))


def _scaled_excess(got, want, tol, scale) -> float:
    """How far ``got`` lies past ``tol · scale``: a layer's gradients are
    held to the largest of them (x's and every weight's), as a train step's
    clipped gradients are to their global norm; the ranks sum them in
    another order than one device does."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return max(float(np.abs(got - want).max()) - tol * scale, 0.0)


def _grad_scale(layer) -> float:
    """The largest |value| of a layer run's gradients."""
    return max(float(np.abs(g).max()) for g in [layer["dx"], *_flat(layer["dw"]).values()])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _own_rows_np(t, rank, shard, n, axis=2):
    """This rank's live rows of a whole (·, ·, N, ·) array, and how many."""
    lo = rank * shard
    live = max(0, min(shard, n - lo))
    return np.take(t, range(lo, lo + live), axis=axis), live


def _ref_layer(case, arrays):
    """The reference's single-device ``attention_apply`` of layer 0 → (out,
    k, v) as numpy."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as ref_attention

    rcfg, _ = configs(case)
    tree = arrays["ref_params"][case[0]][_layer_key(case)]["attn"]
    lp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), tree)
    out, (k, v) = jax.jit(lambda p, x: ref_attention.attention_apply(
        p, x, rcfg, causal=not case[5]))(lp, jnp.asarray(arrays["x"][case[0]]))
    return np.asarray(out), np.asarray(k), np.asarray(v)


@pytest.mark.parametrize("case_id", IDS)
def test_layer_matches_the_reference_single_device(world, case_id):
    arrays, worlds = world
    case = BY_ID[case_id]
    out, k, v = _ref_layer(case, arrays)
    for rank, r in enumerate(worlds[case[6]]):
        got = r[case_id]["layer"]
        assert _excess(got["out"], out, TOL_REF) == 0.0, rank
        shard = got["k"].shape[2]
        for name, want in (("k", k), ("v", v)):
            mine, live = (_own_rows_np(want, rank, shard, case[3]) if case_id in SEQ_IDS
                          else (want, None))
            have = got[name] if live is None else got[name][:, :, :live]
            assert _excess(have, mine, TOL_REF) == 0.0, (rank, name)


@pytest.mark.parametrize("case_id", IDS)
def test_layer_and_its_gradients_match_the_port_single_device(world, one_device, case_id):
    from repro_torch.distributed import sharding
    from repro_torch.train.train_step import mesh_specs

    _, worlds = world
    case = BY_ID[case_id]
    want = one_device[case_id]["layer"]
    cfg = port_cfg(case)
    scale = _grad_scale(want)
    for rank, r in enumerate(worlds[case[6]]):
        got = r[case_id]["layer"]
        assert _excess(got["out"], want["out"], TOL_PORT) == 0.0, rank
        assert _scaled_excess(got["dx"], want["dx"], TOL_PORT, scale) == 0.0, rank
        mesh = _mesh_of(case, rank)
        spec = _flat(mesh_specs(cfg, mesh)[_layer_key(case)][0]["attn"])
        for name, g in _flat(got["dw"]).items():
            w = sharding.local_slice(torch.from_numpy(_flat(want["dw"])[name]), mesh,
                                     spec[name]).numpy()
            assert _scaled_excess(g, w, TOL_PORT, scale) == 0.0, (rank, name)


def test_layer_with_whole_weights_matches_the_port_single_device(world, one_device):
    _, worlds = world
    want = one_device[WHOLE]["layer"]
    scale = _grad_scale(want)
    for rank, r in enumerate(worlds[BY_ID[WHOLE][6]]):
        got = r[WHOLE]["whole"]
        assert _excess(got["out"], want["out"], TOL_PORT) == 0.0, rank
        assert _scaled_excess(got["dx"], want["dx"], TOL_PORT, scale) == 0.0, rank
        for name, g in _flat(got["dw"]).items():
            assert _scaled_excess(g, _flat(want["dw"])[name], TOL_PORT, scale) == 0.0, (rank,
                                                                                         name)
        shard = got["k"].shape[2]
        mine, live = _own_rows_np(want["k"], rank, shard, BY_ID[WHOLE][3])
        assert _excess(got["k"][:, :, :live], mine, TOL_PORT) == 0.0, rank


@pytest.mark.parametrize("case_id", IDS)
def test_train_step_matches_the_port_single_device(world, one_device, case_id):
    _, worlds = world
    want_loss, want_gnorm, want = one_device[case_id]["step"]
    for rank, r in enumerate(worlds[BY_ID[case_id][6]]):
        loss, gnorm, grads = r[case_id]["step"]
        assert abs(loss - want_loss) <= TOL_PORT * max(1.0, abs(want_loss)), rank
        assert abs(gnorm - want_gnorm) <= TOL_PORT * want_gnorm, rank
        for name, g in grads.items():
            assert _excess(g, want[name], TOL_PORT) == 0.0, (rank, name)


def _ref_grads(case, arrays):
    """The reference's loss, global grad norm and ``jax.grad`` of
    ``lm.loss_fn`` on the case's batch."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as ref_lm

    rcfg, _ = configs(case)
    params = jax.tree_util.tree_map(jnp.asarray, arrays["ref_params"][case[0]])
    batch = {k: jnp.asarray(v) for k, v in arrays["batch"][case[0]].items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: ref_lm.loss_fn(p, rcfg, batch)[0]))(params)
    norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in jax.tree_util.tree_leaves(grads))))
    return float(loss), norm, grads


@pytest.mark.parametrize("case_id", IDS)
def test_train_step_matches_the_reference_grad(world, case_id):
    from test_torch_mesh_tp import _ref_leaf

    from repro_torch.train.optimizer import OptimizerConfig

    arrays, worlds = world
    loss_ref, gnorm_ref, grads_ref = _ref_grads(BY_ID[case_id], arrays)
    clip = OptimizerConfig().grad_clip
    scale = min(1.0, clip / gnorm_ref)
    loss, gnorm, grads = worlds[BY_ID[case_id][6]][0][case_id]["step"]
    assert abs(loss - loss_ref) <= TOL_REF * max(1.0, abs(loss_ref))
    assert abs(gnorm - gnorm_ref) <= TOL_REF * gnorm_ref
    for name, g in grads.items():
        want = _ref_leaf(grads_ref, name) * scale
        assert _excess(g, want, TOL_REF) == 0.0, name


@pytest.mark.parametrize("case_id", IDS)
def test_prefill_matches_one_device_and_each_rank_holds_its_cache_block(world, one_device,
                                                                        case_id):
    from repro_torch.serve import kv_cache

    _, worlds = world
    case = BY_ID[case_id]
    cfg = port_cfg(case)
    want_logits, want_cache = one_device[case_id]["prefill"]
    for rank, r in enumerate(worlds[case[6]]):
        logits, cache = r[case_id]["prefill"]
        assert _excess(logits, want_logits, TOL_PORT) == 0.0, rank
        block = kv_cache.local_cache({k: torch.from_numpy(v) for k, v in want_cache.items()},
                                     cfg, _mesh_of(case, rank), batch=B, max_len=max_len(case))
        assert set(cache) == set(block)
        for k in block:
            assert _excess(cache[k], block[k].numpy(), TOL_PORT) == 0.0, (rank, k)


@pytest.mark.parametrize("case_id", IDS)
def test_the_seq_path_gathers_no_weight_and_runs_the_ring(world, case_id):
    """On the "seq" path the ring calls the forward kernel's wrapper (flash
    or DistrAttention) and, in training, delta, dq and dkv, and
    ``attention.gathered`` is never called; below the guard the cut heads'
    layer gathers its weights and no ring runs."""
    from repro_torch.models import attention

    _, worlds = world
    case = BY_ID[case_id]
    cfg = port_cfg(case)
    seq = case_id in SEQ_IDS
    assert attention.seq_layout(cfg, _mesh_of(case), case[3]) == seq
    for rank, r in enumerate(worlds[case[6]]):
        got = r[case_id]
        if seq:
            assert got["layer_calls"]["gathered"] == got["step_calls"]["gathered"] == 0
            assert got["prefill_calls"]["gathered"] == 0
            if rank * _shard(case) >= case[3]:
                continue  # a rank whose rows are all padding launches nothing
            assert got["layer_calls"]["fwd"] > 0 and got["prefill_calls"]["fwd"] > 0
            assert all(got["step_calls"][k] > 0 for k in RING_CALLS), got["step_calls"]
        else:
            assert got["layer_calls"]["gathered"] > 0
            assert got["layer_calls"]["fwd"] == 0  # the single-device kernels, not the ring's


@pytest.mark.parametrize("gate", ["layer", "step", "prefill"])
def test_a_shard_offset_by_one_position_fails_each_gate(world, one_device, gate):
    _, worlds = world
    lead = worlds[BY_ID[FAULTED][6]][0][FAULTED]
    want = one_device[FAULTED][gate]
    got, sound = lead["faulted"][gate], lead[gate]
    if gate == "layer":
        pairs = [(got["out"], want["out"], sound["out"])]
    elif gate == "step":
        pairs = [(got[2][n], want[2][n], sound[2][n]) for n in want[2]]
    else:
        pairs = [(got[0], want[0], sound[0])]
    assert max(_excess(s, w, TOL_PORT) for _, w, s in pairs) == 0.0
    assert max(_excess(g, w, TOL_PORT) for g, w, _ in pairs) > 100 * TOL_PORT
