"""Port parity of the sharding rules (``distributed/sharding.py``): for all
ten configs, published and ``reduced()``, on the reference's meshes (data
16 × model 16, pod 2 × data 16 × model 16) and the 4-rank ones the tests
and the card run (data 2 × model 2, data 2 × context 4 × model 2), the
port's ``param_pspecs(param_axes(cfg))`` over its parameter shapes on the
meta device equals the reference's ``param_pspecs`` over
``jax.eval_shape(init_params)`` leaf for leaf, with the reference's layer
stack entry dropped (one entry, two under the hybrid's ``groups``).  The
batch, KV-cache and activation specs against the reference's on the same
fake meshes (the reference's ``constrain`` read through a stand-in
``with_sharding_constraint``)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import lm  # noqa: E402


class FakeMesh:
    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)

    def __repr__(self):
        return "×".join(f"{a}{s}" for a, s in self.shape.items())


MESHES = [FakeMesh(data=16, model=16), FakeMesh(pod=2, data=16, model=16),
          FakeMesh(data=2, model=2), FakeMesh(data=2, context=4, model=2)]


@functools.lru_cache(maxsize=None)
def _trees(arch: str, reduced: bool):
    rcfg = ref_configs.get_config(arch, reduced=reduced)
    shapes = jax.eval_shape(lambda k: ref_lm.init_params(k, rcfg), jax.random.PRNGKey(0))
    tcfg = configs.get_config(arch, reduced=reduced)
    return rcfg, shapes, tcfg, lm.param_shapes(tcfg)


def _unstack(ref_specs, port_specs, path=""):
    """Every (port spec, reference spec without its stack entries, path)."""
    if isinstance(port_specs, dict):
        assert set(port_specs) == set(ref_specs), path
        for k in port_specs:
            yield from _unstack(ref_specs[k], port_specs[k], f"{path}/{k}")
        return
    if isinstance(port_specs, list) and isinstance(ref_specs, list):  # the shared blocks
        assert len(port_specs) == len(ref_specs), path
        for i, (r, p) in enumerate(zip(ref_specs, port_specs)):
            yield from _unstack(r, p, f"{path}/{i}")
        return
    if isinstance(port_specs, list):  # a layer list: the reference stacks it on dim 0
        for i, p in enumerate(port_specs):
            yield from _unstack(_drop_stack(ref_specs), p, f"{path}/{i}")
        return
    yield port_specs, ref_specs, path


def _drop_stack(ref_specs):
    if isinstance(ref_specs, dict):
        return {k: _drop_stack(v) for k, v in ref_specs.items()}
    assert tuple(ref_specs)[0] is None  # the stack dim is never sharded
    return tuple(ref_specs)[1:]


@pytest.mark.parametrize("mesh", MESHES, ids=repr)
@pytest.mark.parametrize("reduced", [False, True], ids=["published", "reduced"])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_specs_match_reference(arch, reduced, mesh):
    rcfg, ref_shapes, tcfg, port_shapes = _trees(arch, reduced)
    want = ref_shd.param_pspecs(ref_lm.param_axes(rcfg), ref_shapes, mesh, fsdp=rcfg.fsdp)
    got = shd.param_pspecs(lm.param_axes(tcfg), port_shapes, mesh, fsdp=tcfg.fsdp)
    pairs = list(_unstack(want, got))
    assert len(pairs) == len(lm.trainable(port_shapes))
    for port_spec, ref_spec, path in pairs:
        assert isinstance(port_spec, shd.P), path
        assert tuple(port_spec) == tuple(ref_spec), path
    # Every spec divides its dim on this mesh.
    by_path = {path: spec for spec, _, path in pairs}
    for name, t in lm.named_trainable(port_shapes):
        spec = by_path["/" + name]
        for dim, entry in enumerate(spec):
            n = 1
            for a in shd.entry_axes(entry):
                n *= mesh.shape[a]
            assert t.shape[dim] % n == 0, (name, spec)


def test_fsdp_off_leaves_data_unused():
    _, _, tcfg, shapes = _trees("minicpm-2b", False)
    specs = shd.param_pspecs(lm.param_axes(tcfg), shapes, MESHES[2], fsdp=False)
    assert specs["embed"]["table"] == shd.P("model", None)
    assert specs["blocks"][0]["attn"]["wq"]["w"] == shd.P(None, "model")


@pytest.mark.parametrize("mesh", MESHES + [FakeMesh(data=1, context=2, model=2),
                                           FakeMesh(context=4)], ids=repr)
def test_batch_and_cache_specs_match_reference(mesh, monkeypatch):
    assert shd.dp_axes(mesh) == ref_shd.dp_axes(mesh)
    assert shd.data_axis_size(mesh) == ref_shd.data_axis_size(mesh)
    assert tuple(shd.batch_pspec(mesh)) == tuple(ref_shd.batch_pspec(mesh))
    for dim in (1, 2, 3, 4, 6, 8, 16, 32, 48, 256):
        assert shd.dp_axes_for(mesh, dim) == ref_shd.dp_axes_for(mesh, dim), dim
    for seq in (True, False):
        assert (tuple(shd.kv_cache_pspec(mesh, seq_axis_sharded=seq))
                == tuple(ref_shd.kv_cache_pspec(mesh, seq_axis_sharded=seq)))
    monkeypatch.setattr(ref_shd, "NamedSharding", lambda m, spec: spec)
    shapes = {"tokens": jax.ShapeDtypeStruct((32, 128), "int32"),
              "frames": jax.ShapeDtypeStruct((6, 1500, 768), "float32")}
    want = ref_shd.batch_shardings(shapes, mesh)
    got = shd.batch_shardings(shapes, mesh)
    assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("spec", [("data", None, "model"), ("data", "model", "seq", None),
                                  ("data", None, "model", None), ("data", "seq", None)])
@pytest.mark.parametrize("mesh", MESHES + [FakeMesh(data=1, context=2, model=2)], ids=repr)
def test_expand_spec_matches_the_reference_constrain(mesh, spec, monkeypatch):
    """``expand_spec`` is the spec the reference's ``layers.constrain``
    hands to ``with_sharding_constraint`` under an active mesh."""
    import repro.utils.jax_compat as jc
    from repro.models import layers as ref_layers

    class Active(FakeMesh):
        empty = False

    seen = []
    monkeypatch.setattr(jc, "get_abstract_mesh", lambda: Active(**mesh.shape))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s)) or x)
    ref_layers.constrain("x", *spec)
    assert seen == [tuple(shd.expand_spec(mesh, spec))]
    x = torch.ones(2, 3)
    from repro_torch.models import layers

    assert layers.constrain(x, *spec) is x  # a layout hint: no numeric effect


def test_divisibility_guard_drops_the_assignment():
    spec = shd._spec_for((None, "mlp"), (768, 3352), FakeMesh(data=16, model=16), fsdp=False)
    assert spec == ref_shd._spec_for((None, "mlp"), (768, 3352), FakeMesh(data=16, model=16),
                                     fsdp=False, stacked=False) == shd.P(None, None)


def test_local_slices_tile_the_full_tensor():
    """``local_slice`` over every coordinate of a (data 2, model 2) mesh
    tiles the full tensor, in the order ``gather_full`` concatenates."""
    from repro_torch.launch.mesh import HostMesh

    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for spec in (shd.P("data", "model"), shd.P("model", "data"), shd.P(("data", "model"), None),
                 shd.P(None, None)):
        blocks = {}
        for d in range(2):
            for m in range(2):
                mesh = HostMesh(("data", "model"), {"data": 2, "model": 2},
                                {"data": d, "model": m}, {}, {})
                blocks[d, m] = shd.local_slice(full, mesh, spec)
                assert shd.full_shape(blocks[d, m].shape, mesh, spec) == (8, 6)
        rows = sorted({float(b[0, 0]) for b in blocks.values()})
        assert len(rows) == (1 if spec == shd.P(None, None) else 4)
        assert sum(b.numel() for b in blocks.values()) == (
            4 * full.numel() if spec == shd.P(None, None) else full.numel())
