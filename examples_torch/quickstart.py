"""Quickstart: DistrAttention in three steps, on the PyTorch/CUDA port.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import AttentionConfig, DistrConfig, attend, reference_attention
from repro_torch.kernels import ops
from repro_torch.utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. Make some attention inputs (batch 2, 8 heads, 512 tokens, d=64).
    #    Q/K share structure, like real transformer activations do: iid
    #    noise makes softmax outputs collapse to the V-mean and relative
    #    errors meaningless.
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn():
        return torch.randn((2, 8, 512, 64), generator=gen, device=dev)

    base = randn()
    q = 2.0 * base + 0.5 * randn()
    k = 2.0 * base + 0.5 * randn()
    v = randn()

    # 2. Exact attention vs DistrAttention (paper: group similar embedding-dim
    #    columns with LSH, sample Q / fuse K, compute scores over d/G* dims).
    exact = reference_attention(q, k, v, causal=True)
    for g in (2, 4):
        cfg = AttentionConfig(impl="distr", distr=DistrConfig(group_size=g, block_q=128))
        approx = attend(q, k, v, cfg, causal=True)
        rel = float((approx - exact).abs().mean() / exact.abs().mean())
        print(f"G*={g}: score-dim {64}→{64//g}, output rel err {rel:.4f}")

    # 3. The same thing as the fused kernel (CUDA on the card; on the CPU its
    #    plain PyTorch version).
    out = ops.distr_attention(q, k, v, DistrConfig(group_size=2, block_q=128), causal=True)
    print("pallas kernel output:", tuple(out.shape), str(out.dtype).removeprefix("torch."),
          "finite:", bool(torch.isfinite(out).all()))


if __name__ == "__main__":
    main()
