"""The port's block-size model (``repro_torch.core.block_size``, paper
§3.3.1 on Hopper's shared memory) against the reference's
(``repro.core.block_size``, its TPU re-derivation) where the two share the
contract, the Hopper selection rule on its own, and the tuner's table of
compiled tiles against the template grids and constants in
``kernels/csrc``."""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import block_size as ref  # noqa: E402
from repro_torch.core import block_size as bsz  # noqa: E402
from repro_torch.tune.autotune import compiled_tiles, static_tile  # noqa: E402

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "kernels" / "csrc"
SMEM = 227 * 1024


@pytest.mark.parametrize("l,n,d", [(16, 4096, 128), (128, 4096, 128), (256, 2048, 64),
                                   (512, 4096, 112), (1024, 8192, 256)])
def test_io_count_matches_reference(l, n, d):
    """The paper's I(l, m) is the same formula in both packages (exact)."""
    assert bsz.io_count(l, n, d) == ref.io_count(l, n, d)


def test_io_count_prefers_large_l():
    n, d = 4096, 128
    ios = [bsz.io_count(l, n, d) for l in (16, 128, 256, 512)]
    assert ios == sorted(ios, reverse=True) and len(set(ios)) == len(ios)


def test_spec_is_hoppers():
    assert (bsz.SMEM_BYTES, bsz.QUANTUM, bsz.STAGES) == (SMEM, 16, 2)


@pytest.mark.parametrize("w", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("d", [32, 64, 112, 128, 256])
def test_selection_is_aligned_and_fits(d, g, w):
    """The pick is a multiple of mma.sync's 16 in both dims and its
    working set fits 227 KB of shared memory."""
    l, m = bsz.select_block_sizes(d, group_size=g, w=w)
    assert l % 16 == 0 and m % 16 == 0 and l >= 16 and m >= 16
    assert bsz.working_set_bytes(l, m, d, w=w, group_size=g) <= SMEM


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("d", [64, 128])
def test_selection_maximises_l_first(d, g):
    """The paper's rule: among legal tiles the pick's l is the largest, and
    its m the largest at that l."""
    l, m = bsz.select_block_sizes(d, group_size=g)
    legal = bsz.enumerate_block_sizes(d, group_size=g)
    assert l == max(x[0] for x in legal)
    assert m == max(x[1] for x in legal if x[0] == l)
    assert all(ws <= SMEM for _, _, ws in legal)


def test_enumeration_is_exactly_the_fitting_aligned_tiles():
    d, g = 128, 2
    legal = {(l, m) for l, m, _ in bsz.enumerate_block_sizes(d, group_size=g)}
    for l in range(16, 1025, 16):
        for m in range(16, 1025, 16):
            fits = bsz.working_set_bytes(l, m, d, group_size=g) <= SMEM
            assert ((l, m) in legal) == fits


def test_working_set_components():
    """Q tile once, K and V tiles once a ring stage; distr adds Q̂ and a
    K̂ a stage (bf16 elements)."""
    l, m, d = 128, 64, 128
    assert bsz.working_set_bytes(l, m, d) == 2 * (l * d + 2 * 2 * m * d)
    assert bsz.working_set_bytes(l, m, d, group_size=2) == (
        bsz.working_set_bytes(l, m, d) + 2 * (l * d // 2 + 2 * m * d // 2))


def _constants(name: str) -> dict:
    src = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}


def _instantiated(d: int) -> dict:
    """{kernel: {(rows, keys)}} the tile sources under ``kernels/csrc``
    instantiate at head dim ``d``: the template grids of their launches."""
    bwd_tc = _constants("flash_bwd_tc.cuh")
    src = (CSRC / "flash_bwd_tc.cuh").read_text()
    rows = re.search(r"dkv_rows\(\) \{\s*return D > (\d+) \? (\d+) : (\d+);", src)
    dkv_rows = int(rows[2]) if d > int(rows[1]) else int(rows[3])
    walks = {"attn_fwd_mma_kernel": "flash_fwd", "distr_fwd_exact_kernel": "distr_fwd",
             "attn_bwd_dq_mma_kernel": "flash_dq", "attn_bwd_dkv_mma_kernel": "flash_dkv"}
    found: dict = {k: set() for k in ("flash_fwd", "distr_fwd", "flash_dq", "flash_dkv",
                                      "distr_dq", "distr_dkv")}
    for path in sorted(CSRC.glob("*.cu")):
        text = path.read_text()
        for dd, r, k, kern in re.findall(
                r"launch_(?:bwd_)?walk<(\d+), (\d+), (\d+)(?:, \w+)?>\((\w+)<", text):
            if int(dd) == d:
                found[walks[kern]].add((int(r), int(k)))
        for dd, k, dkv in re.findall(r"launch_distr_walk<(\d+), (\d+), (\w+)>\(", text):
            if int(dd) == d:
                found["distr_dkv" if dkv == "true" else "distr_dq"].add(
                    (dkv_rows if dkv == "true" else bwd_tc["DQ_ROWS"], int(k)))
    return found, dkv_rows


@pytest.mark.parametrize("d", [64, 112, 128])
def test_compiled_tiles_match_the_kernel_sources(d):
    """The tuner's compiled tiles are the tiles the sources in
    ``kernels/csrc`` instantiate: in bf16 the template grid of each walk's
    launches (``*_r<rows>.cu``, ``distr_dkv.cu``), which is the tuner's
    grid less its dropped tiles, with the static tile among them; in f32
    the FMA tile alone."""
    from repro_torch.tune import autotune

    fwd_tc, bwd_tc = _constants("flash_fwd_tc.cuh"), _constants("flash_bwd_tc.cuh")
    fwd_f32, bwd_f32 = _constants("attention_tile.cuh"), _constants("attention_bwd_tile.cuh")
    found, dkv_rows = _instantiated(d)
    static = {"flash_fwd": (fwd_tc["BM"], fwd_tc["BN"]), "distr_fwd": (fwd_tc["BM"], fwd_tc["BN"]),
              "flash_dq": (bwd_tc["DQ_ROWS"], bwd_tc["DQ_KEYS"]),
              "distr_dq": (bwd_tc["DQ_ROWS"], bwd_tc["DQ_KEYS"]),
              "flash_dkv": (dkv_rows, bwd_tc["DKV_KEYS"]),
              "distr_dkv": (dkv_rows, bwd_tc["DKV_KEYS"])}
    fma = {"flash_fwd": (fwd_f32["BM"], fwd_f32["BN"]), "distr_fwd": (fwd_f32["BM"], fwd_f32["BN"]),
           "flash_dq": (bwd_f32["DQ_BM"], bwd_f32["DQ_BN"]),
           "distr_dq": (bwd_f32["DQ_BM"], bwd_f32["DQ_BN"]),
           "flash_dkv": (bwd_f32["DKV_BQ"], bwd_f32["DKV_BK"]),
           "distr_dkv": (bwd_f32["DKV_BQ"], bwd_f32["DKV_BK"])}
    for kernel, tiles in found.items():
        compiled = compiled_tiles(kernel, d=d, dtype="bfloat16")
        assert set(compiled) == tiles and len(compiled) == len(tiles)
        dropped = {t for (k, dd, t) in autotune.DROPPED_TILES if (k, dd) == (kernel, d)}
        assert tiles | dropped == set(autotune.tile_grid(kernel, d=d)) and not tiles & dropped
        assert static_tile(kernel, d=d, dtype="bfloat16") == static[kernel] in tiles
        assert compiled_tiles(kernel, d=d, dtype="float32") == [fma[kernel]]
        assert static_tile(kernel, d=d, dtype="float32") == fma[kernel]


def test_sweep_granularities_match_the_kernel_sources():
    """The decode candidates step by the decode tile's keys, the distr
    block_q by the DistrAttention kernel's rows."""
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.tune import autotune

    assert autotune.DT_KEYS == _constants("decode_tc.cuh")["DT_KEYS"]
    assert autotune.ROW_TILE == dk.ROW_TILE
