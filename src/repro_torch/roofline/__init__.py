"""Analytic cost models and the roofline on one H100."""
from repro_torch.roofline import analysis

__all__ = ["analysis"]
