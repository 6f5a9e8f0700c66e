"""The hooks through which the kernel wrappers and the collectives report
their work to a cost counter, with no dependency on the counter itself.

A counter (``roofline.analysis.CostCounter``) is pushed with ``push`` while
it is open; the innermost one counts.  It offers ``quiet()`` (a
context in which it counts no aten op), ``charge_kernel(name, work)`` and
``charge_collective(kind, nbytes)``.  Outside a counter the hooks cost one
list lookup a call.
"""
from __future__ import annotations

import functools

_COUNTERS: list = []


def active_counter():
    """The innermost open counter, or None."""
    return _COUNTERS[-1] if _COUNTERS else None


def push(counter) -> None:
    """Make ``counter`` the active counter (until ``pop``)."""
    _COUNTERS.append(counter)


def pop(counter) -> None:
    _COUNTERS.remove(counter)


def charged(name: str, work_fn):
    """Decorate a kernel wrapper: under a counter each call charges
    ``work_fn(*args, **kwargs)`` (the call's least work) and the aten ops
    inside it count nothing."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            counter = active_counter()
            if counter is None:
                return fn(*args, **kwargs)
            counter.charge_kernel(name, work_fn(*args, **kwargs))
            with counter.quiet():
                return fn(*args, **kwargs)
        return call
    return wrap


def on_wire(fn):
    """Decorate a collective: the aten ops inside it (staging copies, the
    dry path's stand-ins) count nothing; it charges its wire bytes itself
    (``charge_collective``)."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        counter = active_counter()
        if counter is None:
            return fn(*args, **kwargs)
        with counter.quiet():
            return fn(*args, **kwargs)
    return call


def charge_collective(kind: str, wire) -> None:
    """Charge ``wire``'s bytes, the operand a collective of ``kind`` hands
    the wire, to the active counter."""
    counter = active_counter()
    if counter is not None:
        counter.charge_collective(kind, wire.numel() * wire.element_size())
