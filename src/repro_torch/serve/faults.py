"""The serving tier's view of the fault-injection machinery: a re-export of
:mod:`repro_torch.faults`, where the catalog and its documentation live."""
from __future__ import annotations

from repro_torch.faults import (  # noqa: F401
    NULL_INJECTOR,
    POINTS,
    SERVE_POINTS,
    TRAIN_POINTS,
    FaultInjector,
    FaultSpec,
    InjectedFault,
)

__all__ = [
    "NULL_INJECTOR",
    "POINTS",
    "SERVE_POINTS",
    "TRAIN_POINTS",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
]
