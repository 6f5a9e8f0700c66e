#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out PATH] [--only kernels]

In order: prints the card's name and power limit; builds the CUDA kernels
from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a; holds each
kernel against its plain PyTorch version at the serving path's shapes in
bf16 (and times kernel, plain version and, as a yardstick only, one
PyTorch library call); then serves starcoder2-7b at full width with seeded
random weights through ``repro_torch.launch.serve.run`` under
``pallas_distr`` and ``pallas_flash`` (6 requests on 4 slots, max_len 2048,
32 new tokens, greedy), counting each kernel's launches in those runs.  The line before
the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without CUDA, or outside a checkout, it exits non-zero before any result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core rate
# and HBM3 bandwidth.  Bounds are stated against these with the card's
# power limit printed beside them.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Element-wise atol = rtol.  Flash and distr: the reference's bf16
# tolerances (O is rounded to bf16).  Decode: both sides accumulate in f32
# from the same bf16 inputs and the merged output stays f32.
TOL = {"flash": 2e-2, "distr": 3e-2, "decode": 1e-4}
PREFILL_NS = (600, 2048)
DECODE_LENGTHS = (1, 200, 1537, 2048)
SERVE_PROMPTS = (96, 200, 517, 1000, 1100, 1536)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, flush: "torch.Tensor") -> float:
    """Mean ms per call over ``iters`` calls, each timed with CUDA events
    after writing a 256 MiB buffer, so every call finds the 50 MB L2 cold
    as a serving step's layer does.  A ~1 ms device sleep before the start
    event keeps the card busy while the host enqueues the call, so the
    wrapper's host-side latency does not count as kernel time."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(torch, name, got, want, tol) -> float:
    """Element by element, |got - want| <= tol + tol·|want|, and all finite.
    Returns the largest |got - want|; logs the largest error as a share of
    its element's allowance."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=tol, rtol=tol, msg=lambda m: f"{name}: {m}")
    share = float(((got - want).abs() / (tol + tol * want.abs())).max())
    log(f"  {name}: largest error is {share:.3g} of its element's allowance (tol {tol})")
    return max_err(torch, got, want)


def prefill_phase(torch, flush) -> dict:
    """Flash and DistrAttention kernels at the prefill shapes of
    starcoder2-7b: B·Hq = 36, Hkv = 4, d = 128, G* = 2, causal, bf16."""
    import torch.nn.functional as F

    from repro_torch.core.distr_attention import DistrConfig
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops

    hq, hkv, d, g = 36, 4, 128, 2
    dcfg = DistrConfig(group_size=g, block_q=128)
    scale = d ** -0.5
    out = {"flash": {"max_abs_err": 0.0}, "distr": {"max_abs_err": 0.0}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in PREFILL_NS:
        q = torch.randn((1, hq, n, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((1, hkv, n, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((1, hkv, n, d), generator=gen, device="cuda").to(torch.bfloat16)
        qf, kf, vf = q[0].contiguous(), k[0].contiguous(), v[0].contiguous()
        kw = dict(q_per_kv=hq // hkv, scale=scale, causal=True, kv_len=n)
        got = fk.flash_attention_kernel_call(qf, kf, vf, **kw)
        want = fk.flash_attention_plain(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        err_f = check_close(torch, f"flash N={n}", got, want, TOL["flash"])

        qp = ops.pad_to_multiple(q, dcfg.block_q, dim=2)
        q_hat, perms = ops.distr_stage1(dcfg, qp, scale, hkv=hkv)
        q_hat = q_hat[0].contiguous()
        perm = perms[0].to(torch.int32).contiguous()
        dkw = dict(q_per_kv=hq // hkv, causal=True, group_size=g,
                   block_q=dcfg.block_q, kv_len=n)
        got_d = dk.distr_attention_kernel_call(q_hat, kf, vf, perm, **dkw)
        want_d = dk.distr_attention_plain(q_hat, kf, vf, perm, **dkw)
        torch.cuda.synchronize()
        err_d = check_close(torch, f"distr N={n}", got_d, want_d, TOL["distr"])
        out["flash"]["max_abs_err"] = max(out["flash"]["max_abs_err"], err_f)
        out["distr"]["max_abs_err"] = max(out["distr"]["max_abs_err"], err_d)

        # Timings: kernel, plain version, and SDPA as a yardstick (K/V
        # expanded to the query heads outside the timed call).
        kx = k.repeat_interleave(hq // hkv, dim=1)
        vx = v.repeat_interleave(hq // hkv, dim=1)
        t = {
            "flash_ms": time_ms(torch, lambda: fk.flash_attention_kernel_call(qf, kf, vf, **kw), 10, flush),
            "flash_plain_ms": time_ms(torch, lambda: fk.flash_attention_plain(qf, kf, vf, **kw), 3, flush),
            "sdpa_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True), 10, flush),
            "distr_ms": time_ms(torch, lambda: dk.distr_attention_kernel_call(q_hat, kf, vf, perm, **dkw), 10, flush),
            "distr_plain_ms": time_ms(torch, lambda: dk.distr_attention_plain(q_hat, kf, vf, perm, **dkw), 3, flush),
        }
        pairs = n * (n + 1) // 2  # causal (row, key) pairs this input needs
        flops_f = 4 * d * pairs * hq
        bytes_f = 2 * (2 * hq * n * d + 2 * hkv * n * d)
        flops_d = (2 * (d // g) + 2 * d) * pairs * hq
        n_pad = qp.shape[2]
        bytes_d = 2 * (hq * n_pad * (d // g) + 2 * hkv * n * d + hq * n_pad * d) \
            + 4 * hq * (n_pad // dcfg.block_q) * d
        bounds = {
            "flash": (max(flops_f / PEAK_BF16_FLOPS, bytes_f / PEAK_HBM_BYTES) * 1e3,
                      "operations" if flops_f / PEAK_BF16_FLOPS > bytes_f / PEAK_HBM_BYTES else "bytes"),
            "distr": (max(flops_d / PEAK_BF16_FLOPS, bytes_d / PEAK_HBM_BYTES) * 1e3,
                      "operations" if flops_d / PEAK_BF16_FLOPS > bytes_d / PEAK_HBM_BYTES else "bytes"),
        }
        log(f"[prefill N={n}] flash err {err_f:.3e} {t['flash_ms']:.3f} ms "
            f"(plain {t['flash_plain_ms']:.3f}, sdpa {t['sdpa_ms']:.3f}, bound "
            f"{bounds['flash'][0]:.4f}) | distr err {err_d:.3e} {t['distr_ms']:.3f} ms "
            f"(plain {t['distr_plain_ms']:.3f}, bound {bounds['distr'][0]:.4f})")
        out.setdefault("shapes", []).append({"n": n, **t, "flash_bound_ms": bounds["flash"][0],
                                             "distr_bound_ms": bounds["distr"][0]})
        if n == max(PREFILL_NS):  # the headline shape of the JSON line
            out["flash"].update(ms=t["flash_ms"], plain_ms=t["flash_plain_ms"],
                                library_ms=t["sdpa_ms"], bound_ms=bounds["flash"][0],
                                bound_by=bounds["flash"][1])
            out["distr"].update(ms=t["distr_ms"], plain_ms=t["distr_plain_ms"],
                                library_ms=None, bound_ms=bounds["distr"][0],
                                bound_by=bounds["distr"][1])
    return out


def decode_phase(torch, flush) -> dict:
    """The split-K decode kernel at the decode shape of starcoder2-7b:
    B = 4 slots, Hq = 36 over Hkv = 4, S = 2048, lengths {1, 200, 1537,
    2048}, q_len 1 and 2, score width 128 and 64 (fused K̂), bf16."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode as dec
    from repro_torch.kernels.ops import _pack_gqa_rows

    b, hq, hkv, s, d, bk = 4, 36, 4, 2048, 128, 128
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"max_abs_err": 0.0}
    for q_len in (1, 2):
        for ds in (128, 64):
            q = torch.randn((b, hq, q_len, ds), generator=gen, device="cuda").to(torch.bfloat16)
            k = torch.randn((b, hkv, s, ds), generator=gen, device="cuda").to(torch.bfloat16)
            v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
            qp = _pack_gqa_rows(q, hkv)
            kw = dict(scale=d ** -0.5, block_k=bk, q_len=q_len)
            got = dec.merge_splits(*dec.decode_kernel_call(qp, k, v, lengths, **kw))
            want = dec.merge_splits(*dec.decode_plain(qp, k, v, lengths, **kw))
            torch.cuda.synchronize()
            err = check_close(torch, f"decode q_len={q_len} d_score={ds}", got, want, TOL["decode"])
            out["max_abs_err"] = max(out["max_abs_err"], err)
            log(f"[decode q_len={q_len} d_score={ds}] err {err:.3e}")
            if q_len == 1 and ds == d:  # the serving path's shape
                mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None])
                mask = mask[:, None, None, :]
                kx = k.repeat_interleave(hq // hkv, dim=1)
                vx = v.repeat_interleave(hq // hkv, dim=1)
                ms = time_ms(torch, lambda: dec.decode_kernel_call(qp, k, v, lengths, **kw), 20, flush)
                plain_ms = time_ms(torch, lambda: dec.decode_plain(qp, k, v, lengths, **kw), 5, flush)
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask), 20, flush)
                # Live K/V once, q, lengths, and the merged f32 output.  The
                # split partials are the kernel's own traffic, not the work's.
                live = int(lengths.sum())
                rows = hq // hkv * q_len
                nbytes = (2 * live * hkv * (ds + d) + 2 * b * hq * ds + 4 * b
                          + 4 * b * hkv * rows * d)
                flops = 4 * rows * live * hkv * d
                bound = max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS) * 1e3
                out.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                           bound_by="bytes" if nbytes / PEAK_HBM_BYTES > flops / PEAK_BF16_FLOPS
                           else "operations")
                log(f"[decode serve shape] {ms:.4f} ms (plain {plain_ms:.4f}, sdpa "
                    f"{lib_ms:.4f}, bound {bound:.4f})")
    return out


def serve_phase(torch) -> dict:
    """starcoder2-7b at full width, seeded random weights, served through
    the launcher's run function under both kernel impls."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.launch.serve import run
    from repro_torch.models import lm

    cfg = get_config("starcoder2-7b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    log(f"[serve] starcoder2-7b params on the card in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    launches = {"flash": 0, "distr": 0, "decode": 0}
    for impl, kernel in (("pallas_distr", "distr"), ("pallas_flash", "flash")):
        cfg_i = cfg.replace(attention=cfg.attention.with_impl(impl))
        fk.launches = dk.launches = dec.launches = 0
        res = run(cfg_i, params, max_new=32, max_slots=4, max_len=2048,
                  prompt_lens=list(SERVE_PROMPTS), device="cuda")
        counts = {"flash": fk.launches, "distr": dk.launches, "decode": dec.launches}
        log(f"[serve {impl}] {len(res['done'])} requests, {res['tokens']} tokens in "
            f"{res['seconds']:.2f}s ({res['tok_per_s']:.1f} tok/s); launches {counts}")
        for m in res["metrics"]:
            log(f"  req {m['uid']}: status {m['status']} ttft {m['ttft_s']:.4f}s "
                f"tpot {m['tpot_s']:.4f}s n={m['n_generated']}")
        bad = [r.uid for r in res["done"] if r.status != "done" or len(r.generated) != 32]
        if len(res["done"]) != len(SERVE_PROMPTS) or bad:
            raise AssertionError(f"serve {impl}: requests not done: {bad}")
        if counts[kernel] == 0 or counts["decode"] == 0:
            raise AssertionError(f"serve {impl}: a kernel of the path never launched: {counts}")
        launches[kernel] += counts[kernel]
        launches["decode"] += counts["decode"]
    del params
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    ap.add_argument("--only", choices=("kernels",), default=None,
                    help="stop after the kernel phases")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    card = gpu_name_and_power()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.lib()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f}s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  " + line.strip())

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    pre = prefill_phase(torch, flush)
    dec = decode_phase(torch, flush)
    del flush
    results = {"card": card, "prefill_shapes": pre.pop("shapes")}
    launches = {"flash": 0, "distr": 0, "decode": 0}
    if args.only != "kernels":
        launches = serve_phase(torch)

    csrc = "src/repro_torch/kernels/csrc"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda", "source": f"{csrc}/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:41", "launches": launches["flash"],
         **pre["flash"]},
        {"name": "distr_attention_fwd", "route": "cuda", "source": f"{csrc}/distr_attention.cu",
         "replaces": "src/repro/kernels/distr_attention.py:42", "launches": launches["distr"],
         **pre["distr"]},
        {"name": "decode_splitk", "route": "cuda", "source": f"{csrc}/decode.cu",
         "replaces": "src/repro/kernels/decode.py:68", "launches": launches["decode"], **dec},
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: kern[k] for k in keys} for kern in kernels]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({**results, "kernels": kernels}, indent=1))
    log(card)
    log(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
