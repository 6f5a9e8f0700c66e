"""The arithmetic of the bf16 tensor-core SSD kernel (``csrc/ssd_tc.cuh``)
emulated on the CPU, against the plain version and the JAX package.

The kernel cannot run here, so ``_ssd_tc_emulation`` repeats its rounding
with torch in f32: S = C·Bᵀ and every other product summed in f32 from bf16
operands; G = S ∘ L (the A operand of G·X), the carried state H (f32, the
B operand of C·H) and the scaled keys B∘w (the A operand of the state
update) each split into bf16 hi + lo; ``ex2.approx`` as f32 ``exp2`` of log2-scaled cumsums; the
chunks in order.  Held to the tolerances the card holds the kernel to: y
at 2e-2 (bf16 on both sides) and the f32 state at 1e-3, at zamba2-7b's
widths, mamba2-130m's state width 128, a ragged tail and strong decays.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as ref_ref  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro_torch.kernels import ssd as ssd_kernels  # noqa: E402

LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
TOL = {"y": 2e-2, "state": 1e-3}


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _hi_lo(t):
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def _bf16_only(t):
    return (_bf16(t),)


def _ssd_tc_emulation(x, a, b, c, *, heads_per_group, chunk, split_g=_hi_lo, split_h=_hi_lo,
                      split_bw=_hi_lo):
    """y (bf16) and the final f32 state, shapes as ``ssd_plain``'s.  The
    kernel's tile pads a chunk to a multiple of 16 rows with steps that
    change nothing (a = 0, b = c = x = 0), so the emulation takes the live
    steps only."""
    bh, n, p = x.shape
    s = b.shape[2]
    xf = x.float()
    bf = b.float().repeat_interleave(heads_per_group, dim=0)
    cf = c.float().repeat_interleave(heads_per_group, dim=0)
    h = torch.zeros((bh, s, p))
    ys = []
    for t0 in range(0, n, chunk):
        xc, bc, cc = xf[:, t0:t0 + chunk], bf[:, t0:t0 + chunk], cf[:, t0:t0 + chunk]
        a_cum = torch.cumsum(a[:, t0:t0 + chunk].float(), dim=1)
        a2 = a_cum * LOG2E
        q = xc.shape[1]
        tril = torch.arange(q)[None, :] <= torch.arange(q)[:, None]
        # Above the diagonal exp2 may be inf: selected, never multiplied.
        g = torch.where(tril, (cc @ bc.transpose(1, 2)) * torch.exp2(a2[:, :, None] - a2[:, None, :]),
                        0.0)
        y = torch.exp2(a2)[..., None] * sum(cc @ part for part in split_h(h))
        y = y + sum(part @ xc for part in split_g(g))
        ys.append(y.to(x.dtype))
        last = a_cum[:, -1:]
        w = torch.exp2((last - a_cum) * LOG2E)
        h = torch.exp2(last * LOG2E)[..., None] * h + sum(
            part.transpose(1, 2) @ xc for part in split_bw(bc * w[..., None]))
    return torch.cat(ys, dim=1), h


# (label, heads, p, s, chunk, n, decay): zamba2-7b's Mamba-2 widths,
# mamba2-130m's state width, a ragged tail, strong decays (exp overflows
# above the diagonal).
CASES = [
    ("zamba2-7b", 4, 64, 64, 128, 2048, 1.0),
    ("mamba2-130m S=128", 2, 64, 128, 128, 2048, 1.0),
    ("ragged", 3, 64, 64, 128, 600, 1.0),
    ("strong decay", 2, 64, 64, 128, 512, 300.0),
]


def _inputs(h, n, p, s, decay, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((h, n, p), dtype=np.float32)).to(torch.bfloat16)
    a = torch.from_numpy(-np.logaddexp(rng.standard_normal((h, n)), 0).astype(np.float32) * decay)
    bm = torch.from_numpy(rng.standard_normal((1, n, s), dtype=np.float32)).to(torch.bfloat16)
    c = torch.from_numpy(rng.standard_normal((1, n, s), dtype=np.float32)).to(torch.bfloat16)
    return x, a, bm, c


def _f32(t):
    return t.float() if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t, np.float32))


def _share(got, want, tol):
    """The largest |got − want| as a share of its element's allowance."""
    got, want = _f32(got), _f32(want)
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def _close(got, want, tol, what):
    got = got.float()
    assert torch.isfinite(got).all(), what
    torch.testing.assert_close(got, _f32(want), atol=tol, rtol=tol, msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("label,h,p,s,chunk,n,decay", CASES)
def test_ssd_tc_emulation_matches_plain(label, h, p, s, chunk, n, decay):
    """Against ``ssd_plain`` (f32 from the same bf16 inputs).  Logged, not
    asserted: each split replaced by plain bf16.  At zamba2-7b's widths
    that puts y at 6.2 (G), 2.2 (H) and the state at 8.1 (B∘w) times its
    allowance, so the kernel splits all three."""
    x, a, bm, c = _inputs(h, n, p, s, decay, seed=11)
    kw = dict(heads_per_group=h, chunk=chunk)
    y_p, state_p = ssd_kernels.ssd_plain(x, a, bm, c, return_state=True, **kw)
    shares = {}
    for name, split in (("hi + lo", {}), ("G bf16", {"split_g": _bf16_only}),
                        ("H bf16", {"split_h": _bf16_only}), ("B∘w bf16", {"split_bw": _bf16_only})):
        y, state = _ssd_tc_emulation(x, a, bm, c, **split, **kw)
        shares[name] = (_share(y, y_p, TOL["y"]), _share(state, state_p, TOL["state"]))
    print(f"{label}: largest error as a share of the allowance (y, state): {shares}")
    y, state = _ssd_tc_emulation(x, a, bm, c, **kw)
    assert y.dtype == torch.bfloat16 and y.shape == (h, n, p) and state.shape == (h, s, p)
    _close(y, y_p, TOL["y"], "y")
    _close(state, state_p, TOL["state"], "state")


@pytest.mark.parametrize("label,h,p,s,chunk,n,decay", CASES)
def test_ssd_tc_emulation_matches_reference(label, h, p, s, chunk, n, decay):
    """Against the JAX package on the same bf16 inputs, in its (B, N, H, P)
    layout: y against the sequential oracle ``ssd_ref``, the state against
    ``ssd_xla(return_state=True)``."""
    x, a, bm, c = _inputs(h, n, p, s, decay, seed=12)
    y, state = _ssd_tc_emulation(x, a, bm, c, heads_per_group=h, chunk=chunk)
    jx = (jnp.asarray(x.float().numpy()[None].transpose(0, 2, 1, 3)).astype(jnp.bfloat16),
          jnp.asarray(a.numpy()[None].transpose(0, 2, 1)),
          jnp.asarray(bm.float().numpy()[:, :, None]).astype(jnp.bfloat16),
          jnp.asarray(c.float().numpy()[:, :, None]).astype(jnp.bfloat16))
    y_ref = np.asarray(ref_ref.ssd_ref(*jx, chunk=chunk), np.float32)[0].transpose(1, 0, 2)
    _, state_ref = ref_mamba.ssd_xla(*jx, chunk=chunk, return_state=True)
    _close(y, y_ref, TOL["y"], "y against ssd_ref")
    _close(state, np.asarray(state_ref)[0], TOL["state"], "state against ssd_xla")
