"""Side-by-side: exact attention, DistrAttention (plain PyTorch and the
CUDA kernel), and the paper's baseline family (Hydra / Flatten /
Primal-lowrank / Hyper-sampled), on the PyTorch/CUDA port.

  PYTHONPATH=src python examples_torch/attention_showcase.py [--device cpu]
"""
import argparse
import functools
import time

import torch

from repro_torch.core import AttentionConfig, DistrConfig, attend, reference_attention
from repro_torch.core.baselines import BASELINES
from repro_torch.utils.device import resolve_device

B, H, N, D = 2, 8, 1024, 64


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((B, H, N, D), generator=gen, device=dev) for _ in range(3))

    exact = reference_attention(q, k, v, causal=True)

    methods = {
        "exact_flash(xla)": functools.partial(
            attend, cfg=AttentionConfig(impl="xla_flash"), causal=True),
        "distr_g2(xla)": functools.partial(
            attend, cfg=AttentionConfig(impl="distr", distr=DistrConfig(group_size=2)),
            causal=True),
        "distr_g2(pallas)": functools.partial(
            attend, cfg=AttentionConfig(impl="pallas_distr", distr=DistrConfig(group_size=2)),
            causal=True),
    }
    for name, fn in BASELINES.items():
        methods[name] = functools.partial(fn, causal=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    print(f"{'method':22s} {'rel_err':>9s} {'cosine':>8s} {'ms':>8s}")
    with torch.no_grad():
        for name, fn in methods.items():
            out = fn(q, k, v)
            sync()
            t0 = time.perf_counter()
            fn(q, k, v)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            o = out.float()
            rel = float((o - exact).abs().mean() / exact.abs().mean())
            cos = float((o * exact).sum() / (o.norm() * exact.norm()))
            print(f"{name:22s} {rel:9.4f} {cos:8.4f} {ms:8.1f}")


if __name__ == "__main__":
    main()
