"""Training: AdamW with LR schedules, the data streams, the train step, the
trainer loop with its verified checkpoints, anomaly guard, the elastic
control plane and the supervisor that drives it (``repro.train``'s
counterparts; gradient compression is not ported yet)."""
from repro_torch.train import (
    anomaly,
    checkpoint,
    data,
    elastic,
    optimizer,
    supervisor,
    train_step,
    trainer,
)

__all__ = [
    "anomaly",
    "checkpoint",
    "data",
    "elastic",
    "optimizer",
    "supervisor",
    "train_step",
    "trainer",
]
