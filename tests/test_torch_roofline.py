"""Port parity: the analytic cost models and roofline of the port
(``repro_torch.roofline.analysis``, ``repro_torch.kernels.ops.attention_cost``
/ ``ssd_cost``, ``repro_torch.obs.utilization``) against the reference's
on a grid of shapes.  Integers match exactly, floats to a relative 1e-12;
``active_params`` and ``model_flops`` count each package's own init of the
same ``reduced()`` configs.  The constants are the H100 SXM's data-sheet
figures in place of the reference's TPU v5e ones.  The least-work counts
of the kernel rows' bounds (``attention_work``, ``delta_work``,
``ssd_work``, ``decode_attention_work``, ``kernel_bound``) have no
reference counterpart: they are held against brute-force counts over the
masks the kernels' plain versions apply, and against the cost models
where the two must agree."""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.obs import utilization as ref_util  # noqa: E402
from repro.roofline import analysis as RA  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs.utilization import (  # noqa: E402
    achieved_fraction, kernel_bound, roofline_lower_bound_s, utilization_columns,
)
from repro_torch.roofline import analysis as TA  # noqa: E402

FLOAT_REL = 1e-12


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, int) and not isinstance(w, bool):
            assert isinstance(g, int) and g == w, (key, g, w)
        elif isinstance(w, float):
            assert g == pytest.approx(w, rel=FLOAT_REL, abs=0.0), (key, g, w)
        else:
            assert g == w, (key, g, w)


def test_constants_are_the_h100s():
    assert TA.PEAK_FLOPS == 989e12
    assert TA.HBM_BW == 3.35e12
    assert TA.NVLINK_BW == 450e9
    assert TA.PEAK_F32_FLOPS == 67e12
    assert not hasattr(TA, "ICI_BW")
    # The reference keeps its own TPU figures; nothing is shared.
    assert (RA.PEAK_FLOPS, RA.HBM_BW) != (TA.PEAK_FLOPS, TA.HBM_BW)


# (b, hq, n, nk, d): block_q 128 below, equal to and above nk, a ragged
# n, and whisper-small's cross-attention (448 decoder rows over 1500
# encoder keys, a key count no tile divides).
ATTN_SHAPES = ((1, 4, 256, 256, 64), (2, 8, 128, 128, 128), (1, 2, 256, 64, 64),
               (1, 36, 2048, 2048, 128), (3, 4, 200, 300, 112), (4, 12, 448, 1500, 64))


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("group_size", [1, 2, 4, 8])
def test_attention_cost_matches_reference(shape, causal, group_size):
    for block_q in (32, 128, 512):
        kw = dict(causal=causal, group_size=group_size, block_q=block_q)
        _assert_same(tops.attention_cost(*shape, **kw), rops.attention_cost(*shape, **kw))


@pytest.mark.parametrize("n,chunk", [(2048, 128), (600, 128), (256, 64), (100, 64)])
def test_ssd_cost_matches_reference(n, chunk):
    for b, h, p, s in ((1, 112, 64, 64), (2, 24, 64, 128), (1, 4, 16, 8)):
        _assert_same(tops.ssd_cost(b, n, h, p, s, chunk=chunk),
                     rops.ssd_cost(b, n, h, p, s, chunk=chunk))


# Live lengths 0, 1, ragged, exactly max_len and past it.
@pytest.mark.parametrize("length", [0, 1, 200, 1537, 2048, 5000])
@pytest.mark.parametrize("q_len", [1, 32])
def test_decode_attention_cost_matches_reference(length, q_len):
    for (b, hq, hkv, max_len, d), group_size, block_k in itertools.product(
            ((4, 36, 4, 2048, 128), (1, 32, 32, 512, 112), (2, 8, 2, 96, 64)),
            (1, 2, 4, 8), (64, 128, 4096)):
        kw = dict(group_size=group_size, block_k=block_k, q_len=q_len)
        _assert_same(TA.decode_attention_cost(b, hq, hkv, length, max_len, d, **kw),
                     RA.decode_attention_cost(b, hq, hkv, length, max_len, d, **kw))


# Lengths inside the table, at capacity (16 · 128 = 2048) and past it, as a
# padded chunk window overhangs.
@pytest.mark.parametrize("length", [0, 1, 127, 128, 129, 2048, 2079, 10_000])
@pytest.mark.parametrize("q_len", [1, 32])
def test_paged_decode_attention_cost_matches_reference(length, q_len):
    for (b, hq, hkv, max_blocks, bs, d), group_size in itertools.product(
            ((8, 36, 4, 16, 128, 128), (1, 4, 2, 3, 16, 64)), (1, 2, 4, 8)):
        kw = dict(group_size=group_size, q_len=q_len)
        _assert_same(TA.paged_decode_attention_cost(b, hq, hkv, length, max_blocks, bs, d, **kw),
                     RA.paged_decode_attention_cost(b, hq, hkv, length, max_blocks, bs, d, **kw))


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_mesh_prefill_handoff_cost_matches_reference(p):
    for (hq, hkv, n, d), group_size, w in itertools.product(
            ((36, 4, 2048, 128), (8, 8, 301, 64)), (1, 2, 4), (2, 4)):
        kw = dict(group_size=group_size, w=w)
        _assert_same(TA.mesh_prefill_handoff_cost(hq, hkv, n, p, d, **kw),
                     RA.mesh_prefill_handoff_cost(hq, hkv, n, p, d, **kw))


@pytest.mark.parametrize("terms", [(1.0, 2.0, 0.5), (3.0, 2.0, 0.5), (0.1, 0.2, 0.7)])
def test_roofline_terms_match_reference(terms):
    kw = dict(flops_per_dev=1.5, hbm_bytes_per_dev=2.5, coll_bytes_per_dev=3.5,
              coll_by_op={"all-reduce": 3.5})
    got = TA.RooflineTerms(*terms, **kw)
    want = RA.RooflineTerms(*terms, **kw)
    assert got.dominant == want.dominant
    assert got.step_time_s == want.step_time_s == max(terms)
    assert got.as_dict() == want.as_dict()


def test_shapes_match_reference():
    assert {k: vars(v) for k, v in SHAPES.items()} == {k: vars(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", ["starcoder2-7b", "minicpm-2b", "mamba2-130m", "zamba2-7b"])
def test_active_params_and_model_flops_match_reference(arch):
    cfg = get_config(arch, reduced=True)
    ref_cfg = ref_get_config(arch, reduced=True)
    assert cfg.tie_embeddings == ref_cfg.tie_embeddings
    shapes = jax.eval_shape(lambda k: ref_lm.init_params(k, ref_cfg), jax.random.PRNGKey(0))
    want = RA.active_params(ref_cfg, shapes)
    got = TA.active_params(cfg, lm.init_params(cfg, device="cpu"))
    assert got == want
    total, active = got
    assert 0 < active <= total
    for name, shape in SHAPES.items():
        assert TA.model_flops(cfg, shape, active) == RA.model_flops(ref_cfg, REF_SHAPES[name],
                                                                    active)


def test_active_params_counts_a_tied_table_as_the_head():
    cfg = get_config("minicpm-2b", reduced=True)
    table = cfg.padded_vocab * cfg.d_model
    for tied in (True, False):
        c = cfg.replace(tie_embeddings=tied)
        total, active = TA.active_params(c, lm.init_params(c, device="cpu"))
        # Tied: the table is the head and counts; untied: the lookup table
        # is left out and the separate head counts.
        assert total - active == (0 if tied else table)


def test_model_flops_conventions():
    cfg = get_config("starcoder2-7b")
    assert TA.model_flops(cfg, SHAPES["train_4k"], 30_000_000_000) == 6.0 * 30e9 * 256 * 4096
    assert TA.model_flops(cfg, SHAPES["decode_32k"], 30_000_000_000) == 2.0 * 30e9 * 128


# ---------------------------------------------------------------------------
# obs.utilization (tests/test_obs.py's, over the H100 constants)
# ---------------------------------------------------------------------------


def test_roofline_lower_bound_is_max_of_compute_and_memory():
    assert roofline_lower_bound_s(1e12, 1.0, peak_flops=1e12, hbm_bw=1e12) \
        == pytest.approx(1.0)
    assert roofline_lower_bound_s(1.0, 1e12, peak_flops=1e12, hbm_bw=1e12) \
        == pytest.approx(1.0)
    assert roofline_lower_bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert roofline_lower_bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        roofline_lower_bound_s(-1.0, 1.0)


def test_achieved_fraction_bounds_and_validation():
    lb = roofline_lower_bound_s(2e12, 1.0, peak_flops=1e12, hbm_bw=1e12)
    assert achieved_fraction(lb, 2e12, 1.0, peak_flops=1e12, hbm_bw=1e12) \
        == pytest.approx(1.0)
    assert achieved_fraction(2 * lb, 2e12, 1.0, peak_flops=1e12,
                             hbm_bw=1e12) == pytest.approx(0.5)
    with pytest.raises(ValueError):
        achieved_fraction(0.0, 1.0, 1.0)


def test_utilization_columns_from_cost_model():
    cost = TA.decode_attention_cost(4, 8, 2, 64, 512, 64, block_k=64)
    cols = utilization_columns(cost, 1000.0)  # 1 ms measured
    assert set(cols) == {"roofline_flops", "roofline_hbm_bytes",
                        "roofline_lower_bound_us", "roofline_util"}
    assert 0.0 < cols["roofline_util"] <= 1.0
    assert cols["roofline_lower_bound_us"] < 1000.0
    # The same columns as the reference's, but over the H100's peaks.
    ref = ref_util.utilization_columns(cost, 1000.0)
    assert cols["roofline_flops"] == ref["roofline_flops"]
    assert cols["roofline_hbm_bytes"] == ref["roofline_hbm_bytes"]
    assert cols["roofline_lower_bound_us"] == pytest.approx(
        max(cost["total_flops"] / 989e12, cost["hbm_bytes"] / 3.35e12) * 1e6, rel=FLOAT_REL)


# ---------------------------------------------------------------------------
# The kernels' least work (the bounds of chip_smoke.py's kernel rows)
# ---------------------------------------------------------------------------


def _causal_mask(n: int, nk: int) -> torch.Tensor:
    """The mask of the attention kernels' plain versions: row i sees keys
    0..i of nk (``kernels/flash_attention.py``)."""
    return torch.arange(nk)[None, :] <= torch.arange(n)[:, None]


@pytest.mark.parametrize("n,nk", [(1, 1), (5, 5), (3, 7), (7, 3), (128, 128), (200, 300)])
def test_attention_pairs_count_the_kernels_mask(n, nk):
    assert tops.attention_pairs(n, nk, causal=True) == int(_causal_mask(n, nk).sum())
    assert tops.attention_pairs(n, nk, causal=False) == n * nk


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("group_size", [1, 2, 4, 8])
def test_attention_work_counts_the_band_and_each_byte_once(shape, group_size):
    b, hq, n, nk, d = shape
    ds = d // group_size
    for causal, block_q, hkv in itertools.product((False, True), (32, 128), (hq, 1)):
        kw = dict(causal=causal, group_size=group_size, block_q=block_q)
        work = tops.attention_work(b, hq, hkv, n, nk, d, **kw)
        pairs = b * hq * (int(_causal_mask(n, nk).sum()) if causal else n * nk)
        assert work["fwd"]["tensor_flops"] == 2 * (ds + d) * pairs
        assert work["dq"]["tensor_flops"] == 2 * (2 * ds + d) * pairs
        assert work["dkv"]["tensor_flops"] == 2 * (2 * ds + 2 * d) * pairs
        # The forward with and without its f32 LSE.
        with_lse = tops.attention_work(b, hq, hkv, n, nk, d, lse=True, **kw)["fwd"]
        assert with_lse["hbm_bytes"] - work["fwd"]["hbm_bytes"] == 4 * b * hq * n
        # Never more than the reference's model of the mechanism where the
        # model's causal share holds (no more rows than keys), and the same
        # where both count the same work: no mask, K/V a query head.
        cost = tops.attention_cost(b, hq, n, nk, d, **kw)
        if n <= nk:
            assert work["fwd"]["tensor_flops"] <= cost["mxu_flops"]
        assert work["fwd"]["hbm_bytes"] <= cost["hbm_bytes"]
        if not causal and hkv == hq:
            assert work["fwd"]["tensor_flops"] == cost["mxu_flops"]
            if group_size == 1:
                assert work["fwd"]["hbm_bytes"] == cost["hbm_bytes"]
                assert work["fwd"]["f32_flops"] == cost["softmax_flops"]


def test_attention_work_prices_the_distr_inputs():
    b, hq, hkv, n, d, g, bq = 1, 4, 2, 256, 64, 2, 128
    flash = tops.attention_work(b, hq, hkv, n, n, d, causal=True)
    distr = tops.attention_work(b, hq, hkv, n, n, d, causal=True, group_size=g, block_q=bq)
    # Q̂ at the score width in place of Q, plus the int32 permutations.
    assert flash["fwd"]["hbm_bytes"] - distr["fwd"]["hbm_bytes"] \
        == 2 * hq * n * (d - d // g) - 4 * hq * (n // bq) * d
    # dQ̂ written at the score width; dK and dV per query head in f32.
    assert distr["dq"]["hbm_bytes"] - distr["fwd"]["hbm_bytes"] \
        == 2 * hq * n * d + 8 * hq * n + 4 * hq * n * (d // g) - 2 * hq * n * d
    assert distr["dkv"]["hbm_bytes"] - distr["dq"]["hbm_bytes"] \
        == 8 * hq * n * d - 4 * hq * n * (d // g)
    # K̂ fusion: d − d/G* adds a (q-block, key) the block's last row sees.
    keys = sum(min((j + 1) * bq, n) for j in range(n // bq))
    assert distr["fwd"]["f32_flops"] - flash["fwd"]["f32_flops"] == hq * keys * (d - d // g)


def test_delta_work():
    assert tops.delta_work(10, 8, 2) == {"tensor_flops": 0, "f32_flops": 160,
                                         "hbm_bytes": 2 * 2 * 80 + 40}
    assert tops.delta_work(10, 8, 4)["hbm_bytes"] == 2 * 4 * 80 + 40


@pytest.mark.parametrize("n,chunk", [(2048, 128), (600, 128), (256, 64), (100, 64), (3, 64)])
def test_ssd_work_counts_each_chunks_triangle(n, chunk):
    b, h, p, g, s = 2, 4, 16, 2, 8
    work = tops.ssd_work(b, n, h, p, g, s, chunk=chunk)
    starts = range(0, n, chunk)
    tri = sum(int(_causal_mask(min(chunk, n - i), min(chunk, n - i)).sum()) for i in starts)
    assert work["tensor_flops"] == b * h * (2 * tri * (s + p) + 4 * n * s * p)
    assert work["f32_flops"] == b * h * 2 * tri
    assert work["hbm_bytes"] == 4 * b * h * n * p + 4 * b * h * n + 4 * b * g * n * s \
        + 4 * b * h * s * p
    assert work["tensor_flops"] <= tops.ssd_cost(b, -(-n // chunk) * chunk, h, p, s,
                                                 chunk=chunk)["total_flops"]


@pytest.mark.parametrize("q_len", [1, 2, 32])
@pytest.mark.parametrize("group_size", [1, 2])
def test_decode_attention_work_counts_the_band(q_len, group_size):
    hq, hkv, d, cap = 8, 2, 64, 256
    lengths = (0, 1, 31, 200, 256, 300)
    ds = d // group_size
    work = TA.decode_attention_work(lengths, hq, hkv, d, cap, group_size=group_size,
                                    q_len=q_len, table_entries=4)
    # The band of the paged kernel's plain version, capped at the capacity.
    col = torch.arange(cap)[None, :]
    tok = torch.arange(q_len)[:, None]
    pairs = hq * sum(int((col < n - (q_len - 1 - tok)).sum()) for n in lengths)
    live = sum(min(n, cap) for n in lengths)
    rows = len(lengths) * hq * q_len
    assert work["tensor_flops"] == 2 * (ds + d) * pairs
    assert work["f32_flops"] == 4 * pairs
    assert work["hbm_bytes"] == 2 * hkv * live * (ds + d) + 2 * rows * ds \
        + 4 * len(lengths) * 5 + 4 * rows * (d + 2)


def test_decode_attention_work_against_the_models():
    # A tick whose lengths fill whole blocks: the live K/V stream and the
    # products are the models'; the work leaves out their split partials
    # and merge.
    hq, hkv, d, bs, mb = 36, 4, 128, 128, 16
    for n in (128, 1024, 2048):
        work = TA.decode_attention_work([n], hq, hkv, d, bs * mb, table_entries=mb)
        paged = TA.paged_decode_attention_cost(1, hq, hkv, n, mb, bs, d)
        dense = TA.decode_attention_cost(1, hq, hkv, n, bs * mb, d, block_k=bs)
        assert work["tensor_flops"] == paged["mxu_flops"] == dense["mxu_flops"]
        assert work["hbm_bytes"] < paged["hbm_bytes"] and work["hbm_bytes"] < dense["hbm_bytes"]
        assert work["hbm_bytes"] > paged["kv_bytes"]


def test_kernel_bound_names_the_slowest_term():
    by_bytes = kernel_bound({"tensor_flops": 989e9, "f32_flops": 0, "hbm_bytes": 6.7e9}, 4.0)
    assert by_bytes["bound_ms"] == pytest.approx(2.0)
    assert by_bytes["bound_by"] == "bytes"
    assert by_bytes["utilization"] == pytest.approx(0.5)
    by_tensor = kernel_bound({"tensor_flops": 2 * 989e9, "f32_flops": 0, "hbm_bytes": 3.35e9})
    assert by_tensor == {"bound_ms": pytest.approx(2.0), "bound_by": "operations"}
    # f32 work runs at its own peak, not the tensor cores'.
    by_f32 = kernel_bound({"tensor_flops": 0, "f32_flops": 67e9, "hbm_bytes": 0})
    assert by_f32 == {"bound_ms": pytest.approx(1.0), "bound_by": "operations"}
