"""End-to-end training driver on the PyTorch/CUDA port: a llama-style LM
with DistrAttention, the full substrate (data pipeline → train step →
checkpoints → resume).

Default is a small model for a quick demo:

  PYTHONPATH=src python examples_torch/train_lm.py --steps 100 [--device cpu]

The assignment-scale run (~100M params, a few hundred steps) is:

  PYTHONPATH=src python examples_torch/train_lm.py --preset 100m --steps 300
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.train import init_train_params
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer


def build_config(preset: str):
    base = get_config("minicpm-2b", reduced=True)
    if preset == "tiny":
        return base
    if preset == "100m":
        # ~100M params: 12L × d768 × ff2048, 12 heads, 16k vocab
        return base.replace(
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
            d_ff=2048, vocab=16384, compute_dtype="float32",
        )
    raise ValueError(preset)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=("tiny", "100m"), default="tiny")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_example_train"))
    ap.add_argument(
        "--impl", default="distr",
        choices=("distr", "xla_flash", "pallas_distr", "pallas_flash"),
        help="pallas_* trains through the kernels' autograd path (the CUDA "
             "kernels on the card, their plain versions on the CPU)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = build_config(args.preset)
    cfg = cfg.replace(attention=cfg.attention.with_impl(args.impl))
    opt = OptimizerConfig(
        peak_lr=3e-4 if args.preset == "100m" else 1e-3,
        warmup_steps=max(args.steps // 20, 2),
        total_steps=args.steps,
        schedule="wsd",
    )
    data = SyntheticLMData(cfg.vocab, args.batch, args.seq, seed=0)
    params = init_train_params(cfg, seed=0, device=args.device)
    trainer = Trainer(cfg, opt, data, params, workdir=args.workdir, log_every=10,
                      ckpt_every=max(args.steps // 4, 10))
    hist = trainer.run(args.steps)
    print(
        f"\ndone: loss {hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f} "
        f"({len(hist)} steps, attention={args.impl}); "
        f"checkpoints in {args.workdir}/checkpoints"
    )


if __name__ == "__main__":
    main()
