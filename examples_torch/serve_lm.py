"""Serve a small model with batched requests through the continuous-batching
engine (prefill → slot insert → lockstep decode → early slot recycling), on
the PyTorch/CUDA port.

  PYTHONPATH=src python examples_torch/serve_lm.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine
from repro_torch.utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = get_config("qwen2.5-32b", reduced=True)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    engine = ServeEngine(cfg, params, max_slots=4, max_len=128, temperature=0.7, device=dev)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(10):
        prompt = rng.integers(1, cfg.vocab, size=int(rng.integers(4, 20))).tolist()
        engine.add_request(prompt, max_new_tokens=int(rng.integers(4, 12)))

    done = engine.run_to_completion()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests / {tokens} tokens in {dt:.2f}s "
          f"({tokens / dt:.1f} tok/s, 4 slots, continuous batching)")
    for r in done[:5]:
        print(f"  req {r.uid:2d} prompt_len={len(r.prompt):2d} → {r.generated}")


if __name__ == "__main__":
    main()
