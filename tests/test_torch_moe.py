"""Port parity of the MoE layer (``repro_torch.models.moe``) with the
reference's single-device dispatch (``repro.models.moe``, which takes its
one-hot ``dense_onehot`` path with no mesh active): the same seeded numpy
weights and inputs, in f32 on the CPU, through the router, ``moe_apply``
(y and aux) at the reduced llama4-scout-17b-a16e and deepseek-v2-236b
widths, with drops (capacity factor 1), at a decode step's T = 4 and with
and without the shared expert; the index dispatch against the port's
one-hot plain version; and a record of the ops ``moe_apply`` calls, none of
which reads a value back to the host.  Tolerance: atol = rtol = 1e-5
(both packages compute in f32; they differ in summation order only)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from _torch_helpers import one_intra_op_thread  # noqa: E402,F401

ARCHS = ("llama4-scout-17b-a16e", "deepseek-v2-236b")
TOL = 1e-5


def _configs(arch, **kw):
    return (ref_get_config(arch, reduced=True).replace(**kw),
            get_config(arch, reduced=True).replace(**kw))


def _params(rcfg, seed=0):
    """The reference's ``moe_init`` weights, and the same as torch tensors."""
    rparams = ref_moe.moe_init(jax.random.PRNGKey(seed), rcfg)
    tparams = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), rparams)
    return rparams, tparams


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def _dropped(ids: np.ndarray, n_experts: int, cap: int) -> int:
    """Assignments at or past the capacity, counted from the ids alone."""
    mask = (ids[..., None] == np.arange(n_experts)).any(axis=1)  # (T, E)
    rank = np.cumsum(mask, axis=0) - 1
    return int(((rank >= cap) & mask).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    rcfg, tcfg = _configs(arch)
    rparams, tparams = _params(rcfg)
    x = _x(1, 32, rcfg.d_model).reshape(32, -1)
    rw, rids, raux = ref_moe._route(rparams["router"]["w"], jnp.asarray(x), rcfg)
    tw, tids, taux = moe.route(tparams["router"]["w"], torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(rids))
    _close(tw, rw)
    _close(taux, raux)


@pytest.mark.parametrize("b,s", [(2, 16), (4, 1)], ids=["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, b, s):
    """(B, S) = (2, 16), and a decode step's T = 4 (capacity floor min(T, 8))."""
    rcfg, tcfg = _configs(arch)
    rparams, tparams = _params(rcfg)
    x = _x(b, s, rcfg.d_model)
    ry, raux = ref_moe.moe_apply(rparams, jnp.asarray(x), rcfg)
    ty, taux = moe.moe_apply(tparams, torch.from_numpy(x), tcfg)
    assert ty.shape == (b, s, rcfg.d_model) and ty.dtype == torch.float32
    _close(ty, ry)
    _close(taux, raux)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_drops_match_reference(arch):
    """Capacity factor 1 at T = 32: assignments are dropped, as many in both
    packages, and y still matches (dropped weights are not renormalised)."""
    rcfg, tcfg = _configs(arch, capacity_factor=1.0)
    rparams, tparams = _params(rcfg)
    x = _x(2, 16, rcfg.d_model, seed=5)
    t = 32
    cap = moe.capacity(tcfg, t)
    assert cap == max(int(rcfg.capacity_factor * t * rcfg.moe_top_k / rcfg.n_experts),
                      min(t, 8))
    _, rids, _ = ref_moe._route(rparams["router"]["w"], jnp.asarray(x.reshape(t, -1)), rcfg)
    _, tids, _ = moe.route(tparams["router"]["w"], torch.from_numpy(x.reshape(t, -1)), tcfg)
    ref_dropped = _dropped(np.asarray(rids), rcfg.n_experts, cap)
    port_dropped = int((moe.queue_ranks(tids, tcfg.n_experts) >= cap).sum())
    assert port_dropped == ref_dropped > 0
    ry, raux = ref_moe.moe_apply(rparams, jnp.asarray(x), rcfg)
    ty, taux = moe.moe_apply(tparams, torch.from_numpy(x), tcfg)
    _close(ty, ry)
    _close(taux, raux)


@pytest.mark.parametrize("shared", [0, 1, 2], ids=["no_shared", "shared", "two_shared"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shared_expert_matches_reference(arch, shared):
    """The shared expert (a SwiGLU MLP of n_shared · d_ff_expert), added
    after the routed experts' output is cast back to x's dtype."""
    rcfg, tcfg = _configs(arch, n_shared_experts=shared)
    rparams, tparams = _params(rcfg, seed=2)
    assert ("shared" in tparams) == bool(shared)
    if shared:
        assert tparams["shared"]["up"]["w"].shape == (rcfg.d_model,
                                                        shared * rcfg.d_ff_expert)
    x = _x(2, 8, rcfg.d_model, seed=3)
    ry, _ = ref_moe.moe_apply(rparams, jnp.asarray(x), rcfg)
    ty, _ = moe.moe_apply(tparams, torch.from_numpy(x), tcfg)
    _close(ty, ry)


@pytest.mark.parametrize("capacity_factor", [4.0, 1.0], ids=["roomy", "drops"])
@pytest.mark.parametrize("b,s", [(2, 16), (4, 1), (1, 40)], ids=["prefill", "decode", "ragged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_index_dispatch_matches_onehot(arch, b, s, capacity_factor):
    """The index form against the port's one-hot plain version: the same
    ids, y and aux."""
    _, tcfg = _configs(arch, capacity_factor=capacity_factor)
    params = moe.moe_init(torch.Generator().manual_seed(0), tcfg)
    x = torch.from_numpy(_x(b, s, tcfg.d_model, seed=4))
    y, aux, ids = moe.moe_routed(params, x, tcfg)
    y1, aux1, ids1 = moe.moe_routed(params, x, tcfg, onehot=True)
    assert torch.equal(ids, ids1)
    torch.testing.assert_close(y, y1, atol=TOL, rtol=TOL)
    torch.testing.assert_close(aux, aux1, atol=0.0, rtol=0.0)


def test_index_dispatch_bf16_matches_onehot():
    """bf16 activations and weights, the router f32: y comes back in bf16
    from f32 expert products in both forms."""
    _, tcfg = _configs("llama4-scout-17b-a16e", capacity_factor=1.0)
    params = moe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert params["router"]["w"].dtype == torch.float32
    assert params["experts"]["gate"].dtype == torch.bfloat16
    x = torch.from_numpy(_x(2, 16, tcfg.d_model)).to(torch.bfloat16)
    y, _ = moe.moe_apply(params, x, tcfg)
    y1, _ = moe.moe_apply_onehot(params, x, tcfg)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), y1.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("chunk_bytes", [1, 10**9], ids=["one_expert_a_chunk", "all_at_once"])
def test_expert_chunks_do_not_change_the_result(monkeypatch, chunk_bytes):
    """The f32 upcast of bf16 expert weights a chunk of experts at a time
    gives the one-shot einsum's result; f32 weights (training's master
    weights, which need no upcast) always run in one product."""
    _, tcfg = _configs("deepseek-v2-236b")
    params = moe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    xe = torch.randn((tcfg.n_experts, 5, tcfg.d_model), generator=torch.Generator().manual_seed(1))
    w = params["experts"]
    w32 = {k: t.float() for k, t in w.items()}
    gate = torch.einsum("ecd,edf->ecf", xe, w32["gate"])
    up = torch.einsum("ecd,edf->ecf", xe, w32["up"])
    want = torch.einsum("ecf,efd->ecd", torch.nn.functional.silu(gate) * up, w32["down"])
    monkeypatch.setattr(moe, "EXPERT_CHUNK_BYTES", chunk_bytes)
    chunk = moe._expert_chunk(w)
    assert chunk == 1 if chunk_bytes == 1 else chunk >= tcfg.n_experts
    assert moe._expert_chunk(w32) == tcfg.n_experts
    torch.testing.assert_close(moe.expert_ffn(w, xe), want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(moe.expert_ffn(w32, xe), want, atol=TOL, rtol=TOL)


class _OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(func._overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("b,s", [(2, 16), (4, 1)], ids=["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_reads_nothing_back_to_the_host(arch, b, s):
    """Every op ``moe_apply`` dispatches, recorded on the CPU: no bincount
    (its length depends on the data), no nonzero and no read of a value
    (``_local_scalar_dense``: ``.item()``, a branch on a tensor), so the
    decode step that holds the layer can be captured as a CUDA graph (the
    capture itself: ``tests/test_torch_cuda.py -k moe`` on the card)."""
    _, tcfg = _configs(arch, capacity_factor=1.0)
    params = moe.moe_init(torch.Generator().manual_seed(0), tcfg)
    x = torch.from_numpy(_x(b, s, tcfg.d_model))
    with _OpRecorder() as rec:
        moe.moe_apply(params, x, tcfg)
    assert {"topk", "cumsum", "bmm"} <= rec.ops
    assert not rec.ops & {"bincount", "nonzero", "_local_scalar_dense", "item", "unique",
                          "masked_select"}
