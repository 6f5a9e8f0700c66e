"""Serving launcher: the slot engine over a model with seeded random weights.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \
      --impl pallas_distr --requests 6 --max-new 32 --max-len 2048

``--arch`` takes every registered config: the dense starcoder2-7b,
minicpm-2b, qwen1.5-4b and qwen2.5-32b (its 64 layers, ≈ 65.5 GB in bf16,
leave little of one card for the cache), the MoE llama4-scout-17b-a16e and
deepseek-v2-236b (MLA; ≈ 215.5 and 471.5 GB in bf16: neither fits one card
whole), the attention-free mamba2-130m and the hybrid zamba2-7b.  Runs on the GPU unless ``--device cpu`` is
given (then use ``--reduced``: the CPU runs the kernels' plain PyTorch
versions).  ``--trace PATH`` records each
request's lifecycle span (admission → prefill → decode → terminal) and the
step spans as a Chrome trace_event JSON; ``--metrics-out PATH`` writes the
metrics snapshot (``obs.metrics.serving_registry``: the engine's frozen
counters and TTFT / TPOT histograms).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.api import IMPLS
from repro_torch.models import lm
from repro_torch.obs import TraceRecorder, perf_clock, serving_registry
from repro_torch.serve.engine import ServeEngine
from repro_torch.utils.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, params, *, requests: int = 8, max_new: int = 16, max_slots: int = 4,
        max_len: int = 256, temperature: float = 0.0,
        prompt_lens: list[int] | None = None, seed: int = 0,
        device: str | torch.device = "cuda", trace=None) -> dict:
    """Serve ``requests`` random prompts to completion.  Prompt lengths are
    ``prompt_lens`` when given, else drawn in [4, 16] as the reference
    launcher does; ``trace`` is the recorder the engine emits to (None: the
    process-global one).  Returns the engine (for ``serving_registry``),
    the finished requests, per-request metrics, the token count, the wall
    time and tokens/s."""
    dev = resolve_device(device)
    eng = ServeEngine(cfg, params, max_slots=max_slots, max_len=max_len,
                      temperature=temperature, seed=seed, device=dev, trace=trace)
    rng = np.random.default_rng(seed)
    lens = prompt_lens if prompt_lens is not None else [
        int(rng.integers(4, 17)) for _ in range(requests)
    ]
    _sync(dev)
    t0 = perf_clock()
    for n in lens:
        eng.add_request(rng.integers(1, cfg.vocab, size=n).tolist(), max_new_tokens=max_new)
    done = eng.run_to_completion()
    _sync(dev)
    dt = perf_clock() - t0
    total = sum(len(r.generated) for r in done)
    return {"engine": eng, "done": done, "metrics": eng.metrics(), "tokens": total,
            "seconds": dt, "tok_per_s": total / dt}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--impl", choices=IMPLS, default=None,
                    help="attention impl (default: the config's)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prompt-lens", default=None,
                    help="comma-separated prompt lengths (overrides --requests)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="after one warm-up run, profile a second run: device "
                         "time by kernel and the device's busy share")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace_event JSON of the run")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a typed metrics snapshot of the run")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.impl is not None:
        cfg = cfg.replace(attention=cfg.attention.with_impl(args.impl))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    lens = ([int(x) for x in args.prompt_lens.split(",")] if args.prompt_lens
            else None)
    kw = dict(requests=args.requests, max_new=args.max_new, max_slots=args.max_slots,
              max_len=args.max_len, temperature=args.temperature, prompt_lens=lens,
              device=dev)
    rec = TraceRecorder() if args.trace else None
    out = run(cfg, params, trace=rec, **kw)
    print(f"[serve] {len(out['done'])} requests, {out['tokens']} tokens in "
          f"{out['seconds']:.2f}s ({out['tok_per_s']:.1f} tok/s)")
    for m in out["metrics"]:
        print(f"  req {m['uid']}: ttft {m['ttft_s']:.4f}s tpot {m['tpot_s']:.4f}s")
    for r in out["done"][:4]:
        print(f"  req {r.uid}: {r.generated[:12]}")
    if rec is not None:
        rec.save(args.trace)
        print(f"[serve] trace: {args.trace} ({len(rec.events)} events)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(serving_registry(out["engine"]).snapshot(), f, indent=1)
        print(f"[serve] metrics: {args.metrics_out}")
    if args.profile:
        _profile(cfg, params, kw, dev)
    return out


def device_busy_s(prof) -> float:
    """Seconds of device work a finished ``torch.profiler`` run recorded:
    the summed duration of every device event (kernels, copies, memsets),
    read from the profiler's raw events.  It builds no ``key_averages()``
    event tree, which takes minutes for the ≈ 10^6 launches of an eager
    serving run."""
    from torch.autograd import DeviceType

    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e9


def _profile(cfg, params, kw: dict, dev: torch.device) -> None:
    """Profile one more (warm) run and print the device's busy share and
    the device time of each of the port's own kernels (``rt::``)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        out = run(cfg, params, **kw)
    events = prof.key_averages()
    sort = "self_cuda_time_total" if cuda else "self_cpu_time_total"
    print(events.table(sort_by=sort, row_limit=20))
    if cuda:
        def device_us(e):
            return (getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0))

        for e in sorted((e for e in events if "rt::" in e.key), key=device_us, reverse=True):
            print(f"[profile] {e.key}: {device_us(e) / 1e3:.3f} ms over {e.count} calls")
        busy = device_busy_s(prof)
        print(f"[profile] device busy {busy:.4f}s of {out['seconds']:.4f}s "
              f"wall ({busy / out['seconds']:.1%}); "
              f"{out['tok_per_s']:.1f} tok/s under the profiler")


if __name__ == "__main__":
    main()
