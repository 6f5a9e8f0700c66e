"""Port parity of the architecture registry: every arch the port registers
has the reference's published and ``reduced()`` dimensions on every field
both packages carry (the attention and DistrAttention sub-configs
included), the derived properties agree, ``ARCH_NAMES`` equals the
reference's (its order too, which ``list_configs`` follows), and
``input_specs`` gives every arch's inputs of every named shape as the
reference's does."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro_torch import configs  # noqa: E402

DERIVED = ("padded_vocab", "head_dim_", "qk_head_dim", "is_attention_free", "d_inner",
           "ssm_heads")


def _shared(port_obj, ref_obj) -> list[str]:
    ref_fields = {f.name for f in dataclasses.fields(ref_obj)}
    return [f.name for f in dataclasses.fields(port_obj) if f.name in ref_fields]


# Fields the port sets otherwise on purpose, {(class name, field): (the
# port's value, the reference's values)}: DistrConfig's key tile, which the
# port leaves to its kernel's static tile (None: 64 keys under
# REPRO_TUNE=off, a tile its sources compile) where the reference pins its
# own (128, and 32 in reduced()).
DELIBERATE = {("DistrConfig", "block_k"): (None, (128, 32))}


def _assert_same(port_obj, ref_obj, where: str) -> None:
    for name in _shared(port_obj, ref_obj):
        got, want = getattr(port_obj, name), getattr(ref_obj, name)
        deliberate = DELIBERATE.get((type(port_obj).__name__, name))
        if deliberate is not None:
            assert got == deliberate[0] and want in deliberate[1], (
                f"{where}.{name}: {got!r}, {want!r}")
        elif dataclasses.is_dataclass(got):
            _assert_same(got, want, f"{where}.{name}")
        else:
            assert got == want, f"{where}.{name}: {got!r} != {want!r}"


@pytest.mark.parametrize("reduced", [False, True], ids=["published", "reduced"])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_config_matches_reference(arch, reduced):
    got = configs.get_config(arch, reduced=reduced)
    want = ref_configs.get_config(arch, reduced=reduced)
    _assert_same(got, want, arch)
    assert {p: getattr(got, p) for p in DERIVED} == {p: getattr(want, p) for p in DERIVED}
    # Every field the port drops is one the port has no use for.
    dropped = {f.name for f in dataclasses.fields(want)} - {f.name for f in dataclasses.fields(got)}
    assert not dropped & {"n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
                          "head_dim", "qkv_bias", "rope_theta", "tie_embeddings"}


@pytest.mark.parametrize("reduced", [False, True], ids=["published", "reduced"])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_distribution_fields_match_reference(arch, reduced):
    """``fsdp`` and ``attn_shard``, which the sharding rules read, are the
    reference's on every config."""
    got = configs.get_config(arch, reduced=reduced)
    want = ref_configs.get_config(arch, reduced=reduced)
    assert (got.fsdp, got.attn_shard) == (want.fsdp, want.attn_shard)


def test_registry_order_and_list_configs():
    names = configs.ARCH_NAMES
    assert names == ref_configs.ARCH_NAMES  # every arch the reference registers
    assert [c.name for c in configs.list_configs()] == list(names)
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("shape", sorted(configs.SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_input_specs_match_reference(arch, shape):
    """The same keys in the same order, shapes and dtypes as the reference's
    ``ShapeDtypeStruct`` stand-ins (the port gives ``(shape, dtype)``
    pairs), the stub frontends' embeddings among them."""
    import jax.numpy as jnp

    got = configs.input_specs(configs.get_config(arch), configs.SHAPES[shape])
    want = ref_configs.input_specs(ref_configs.get_config(arch), ref_configs.SHAPES[shape])
    assert list(got) == list(want)
    dtypes = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16}
    for key, (shp, dtype) in got.items():
        assert shp == want[key].shape and dtypes[dtype] == want[key].dtype, key


def test_encdec_and_vlm_published_shapes():
    """The published dimensions the reference's tests hold
    (tests/test_models_smoke.py), and the fields of the two families."""
    whisper = configs.get_config("whisper-small")
    assert (whisper.n_layers, whisper.d_model, whisper.n_heads, whisper.n_kv_heads,
            whisper.d_ff, whisper.vocab) == (12, 768, 12, 12, 3072, 51865)
    assert (whisper.family, whisper.n_encoder_layers, whisper.pos, whisper.frontend,
            whisper.cross_len, whisper.learned_pos_len) == (
        "encdec", 12, "learned", "audio_stub", 1500, 32768)
    assert (whisper.act, whisper.norm, whisper.head_dim_, whisper.padded_vocab) == (
        "gelu", "layernorm", 64, 51968)
    vlm = configs.get_config("internvl2-2b")
    assert (vlm.n_layers, vlm.d_model, vlm.n_heads, vlm.n_kv_heads, vlm.d_ff, vlm.vocab) == (
        24, 2048, 16, 8, 8192, 92553)
    assert (vlm.family, vlm.frontend, vlm.num_patch_tokens, vlm.pos, vlm.padded_vocab) == (
        "dense", "patch_stub", 256, "rope", 92672)
    # Every other config keeps RoPE and no frontend.
    for name in configs.ARCH_NAMES:
        cfg = configs.get_config(name)
        if name not in ("whisper-small", "internvl2-2b"):
            assert (cfg.pos, cfg.frontend, cfg.n_encoder_layers) == ("rope", None, 0)


def test_qwen_published_shapes():
    qwen4 = configs.get_config("qwen1.5-4b")
    assert (qwen4.n_heads, qwen4.n_kv_heads, qwen4.head_dim_, qwen4.qkv_bias) == (20, 20, 128, True)
    assert (qwen4.vocab, qwen4.padded_vocab) == (151936, 152064)
    qwen32 = configs.get_config("qwen2.5-32b")
    assert qwen32.n_heads // qwen32.n_kv_heads == 5 and qwen32.rope_theta == 1e6
    assert qwen32.vocab == qwen32.padded_vocab == 152064
    assert configs.get_config("qwen1.5-4b", reduced=True).head_dim_ == 32


# The published dimensions the reference's tests hold (tests/test_models_smoke.py):
# (n_layers, d_model, n_heads, n_kv_heads, d_ff, vocab).
MOE_DIMS = {"llama4-scout-17b-a16e": (48, 5120, 40, 8, 8192, 202048),
            "deepseek-v2-236b": (60, 5120, 128, 128, 12288, 102400)}


@pytest.mark.parametrize("arch", sorted(MOE_DIMS))
def test_moe_published_shapes(arch):
    cfg = configs.get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab) == MOE_DIMS[arch]
    assert cfg.family == "moe" and (cfg.capacity_factor, cfg.router_aux_weight) == (1.25, 0.01)
    if arch == "deepseek-v2-236b":
        assert (cfg.n_experts, cfg.moe_top_k, cfg.n_shared_experts, cfg.d_ff_expert) == (
            160, 6, 2, 1536)
        assert cfg.use_mla and cfg.first_dense_layers == 1
        assert (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_head_dim, cfg.v_head_dim) == (
            1536, 512, 192, 128)
    else:
        assert (cfg.n_experts, cfg.moe_top_k, cfg.n_shared_experts, cfg.d_ff_expert) == (
            16, 1, 1, 8192)
        assert not cfg.use_mla and cfg.qk_head_dim == cfg.head_dim_ == 128


@pytest.mark.parametrize("arch", sorted(MOE_DIMS))
def test_moe_active_params_match_reference(arch):
    """``roofline.analysis.active_params`` counts routed experts × k/E: at
    the published size over the reference's parameter shapes (no weights
    made), and over the port's own ``reduced()`` parameters."""
    import jax

    from repro.models import lm as ref_lm
    from repro.roofline import analysis as ref_analysis
    from repro_torch.models import lm
    from repro_torch.roofline import analysis

    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    shapes = jax.eval_shape(lambda k: ref_lm.init_params(k, rcfg), jax.random.PRNGKey(0))
    total, active = analysis.active_params(cfg, shapes)
    assert (total, active) == ref_analysis.active_params(rcfg, shapes)
    assert {"llama4-scout-17b-a16e": (107_771_827_200, 16_139_392_000),
            "deepseek-v2-236b": (235_741_434_880, 20_851_512_320)}[arch] == (total, active)
    cfg, rcfg = configs.get_config(arch, reduced=True), ref_configs.get_config(arch, reduced=True)
    got = analysis.active_params(cfg, lm.init_params(cfg, device="cpu"))
    assert got == ref_analysis.active_params(rcfg, ref_lm.init_params(jax.random.PRNGKey(0), rcfg))
