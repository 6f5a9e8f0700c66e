"""Training: AdamW with LR schedules, synthetic data, the train step and
the trainer loop (``repro.train``'s counterparts)."""
