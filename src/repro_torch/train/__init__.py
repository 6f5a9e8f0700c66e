"""Training: AdamW with LR schedules, the data streams, the train step, the
trainer loop with its verified checkpoints, anomaly guard and the elastic
counter schema (``repro.train``'s counterparts; the supervisor and gradient
compression are not ported yet)."""
