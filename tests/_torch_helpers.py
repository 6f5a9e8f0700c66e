"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``).

A module that holds torch to one intra-op thread imports the fixture by
name, which makes it autouse there:

    from _torch_helpers import one_intra_op_thread  # noqa: F401
"""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread while the importing module runs: its many small
    steps lose most of their time to thread hand-offs when test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def with_drawn_qkv_bias(rparams, seed: int = 0, scale: float = 0.5):
    """The reference tree with its QKV biases drawn from a seed (the init
    leaves them 0, which would leave the bias path untested)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    attn = dict(rparams["blocks"]["attn"])
    for name in ("wq", "wk", "wv"):
        b = np.asarray(attn[name]["b"])
        attn[name] = {**attn[name], "b": jnp.asarray(scale * rng.standard_normal(b.shape),
                                                     jnp.float32)}
    return {**rparams, "blocks": {**rparams["blocks"], "attn": attn}}


def load_reduced_models(arch: str, *, draw_qkv_bias: bool, perms: bool = False):
    """``arch``'s ``reduced()`` config in both packages, the reference's
    weights from ``PRNGKey(0)`` (QKV biases drawn when ``draw_qkv_bias``)
    and the port's converted from them on the CPU, with the reference's LSH
    projection.  Returns (rcfg, rparams, tcfg, tparams), and the reference's
    static permutations converted as a fifth item when ``perms``."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.core import lsh as ref_lsh
    from repro.models import lm as ref_lm
    from repro_torch.configs import get_config
    from repro_torch.models.convert import from_jax_params

    rcfg = ref_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    rparams = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    if draw_qkv_bias:
        rparams = with_drawn_qkv_bias(rparams)
    dcfg = rcfg.attention.distr
    proj = np.array(ref_lsh.make_projection(jax.random.PRNGKey(dcfg.proj_seed), dcfg.block_q))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, rparams), tcfg, proj=proj,
                              device="cpu")
    if not perms:
        return rcfg, rparams, tcfg, tparams
    from repro.serve import kv_cache as ref_kvc
    from repro_torch.models.convert import convert_perms

    return rcfg, rparams, tcfg, tparams, convert_perms(np.asarray(ref_kvc.static_perms(rcfg)),
                                                       tcfg, "cpu")
