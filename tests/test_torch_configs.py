"""Port parity of the architecture registry: every arch the port registers
has the reference's published and ``reduced()`` dimensions on every field
both packages carry (the attention and DistrAttention sub-configs
included), the derived properties agree, and ``list_configs`` follows
``ARCH_NAMES``, which keeps the reference's registry order."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro_torch import configs  # noqa: E402

DERIVED = ("padded_vocab", "head_dim_", "is_attention_free", "d_inner", "ssm_heads")


def _shared(port_obj, ref_obj) -> list[str]:
    ref_fields = {f.name for f in dataclasses.fields(ref_obj)}
    return [f.name for f in dataclasses.fields(port_obj) if f.name in ref_fields]


def _assert_same(port_obj, ref_obj, where: str) -> None:
    for name in _shared(port_obj, ref_obj):
        got, want = getattr(port_obj, name), getattr(ref_obj, name)
        if dataclasses.is_dataclass(got):
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


def test_registry_order_and_list_configs():
    names = configs.ARCH_NAMES
    assert set(names) <= set(ref_configs.ARCH_NAMES)
    assert list(names) == [n for n in ref_configs.ARCH_NAMES if n in names]
    assert [c.name for c in configs.list_configs()] == list(names)
    with pytest.raises(KeyError):
        configs.get_config("whisper-small")


def test_qwen_published_shapes():
    qwen4 = configs.get_config("qwen1.5-4b")
    assert (qwen4.n_heads, qwen4.n_kv_heads, qwen4.head_dim_, qwen4.qkv_bias) == (20, 20, 128, True)
    assert (qwen4.vocab, qwen4.padded_vocab) == (151936, 152064)
    qwen32 = configs.get_config("qwen2.5-32b")
    assert qwen32.n_heads // qwen32.n_kv_heads == 5 and qwen32.rope_theta == 1e6
    assert qwen32.vocab == qwen32.padded_vocab == 152064
    assert configs.get_config("qwen1.5-4b", reduced=True).head_dim_ == 32
