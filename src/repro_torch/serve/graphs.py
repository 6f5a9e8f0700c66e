"""CUDA graphs over the serving steps: the port's counterpart of the
reference's ``jax.jit`` at its step sites (``serve/engine.py``: the slot
decode step, the paged decode tick and the chunked-prefill window).

A decode step issues hundreds to thousands of small launches whose host
cost exceeds their device time; one graph replay issues them all at once.

``StepGraph(fn, inputs=...)`` wraps a step function.  The arguments at
the positions ``inputs`` change from step to step (tokens, positions,
block tables): on the card they are copied into buffers the graph owns.
Every other argument (weights, caches, pools) is read by address: the
caller keeps it at a fixed address and updates it in place, and a replay
whose resident tensors moved raises.  For each static shape of the inputs
the first call runs ``fn`` eagerly on the graph's side stream (the warm-up:
lazy allocations, the kernels' build and the libraries' workspaces happen
there), the second captures it with ``torch.cuda.graph`` and replays it,
and every later call copies and replays, so every call runs the step
exactly once.  Outputs are the graph's static tensors: the caller consumes
or copies them before the next call.  A capture or replay error raises;
nothing falls back to eager on a card.  On the CPU a ``StepGraph`` is
``fn`` itself, run eagerly.

The kernels' ``launches`` counters live in Python and advance when a
wrapper launches, that is at capture, never at replay.  ``StepGraph``
takes back the advance it saw during capture (a capture runs nothing) and
adds it on every replay, so the counters equal the launches the card ran.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import (
    backward, decode, distr_attention, flash_attention, paged_decode, ssd,
)

_COUNTED = {"flash_attention": flash_attention, "distr_attention": distr_attention,
            "decode": decode, "paged_decode": paged_decode, "ssd": ssd}

#: One side stream a device, shared by every StepGraph (see ``_side_stream``).
_SIDE_STREAMS: dict = {}


class LaunchCounters:
    """The kernel wrappers' ``launches`` counters read and advanced as one
    dict: one int a module, and backward's five by kernel."""

    def read(self) -> dict[str, int]:
        out = {name: mod.launches for name, mod in _COUNTED.items()}
        out.update({f"backward.{k}": v for k, v in backward.launches.items()})
        return out

    def add(self, delta: dict[str, int]) -> None:
        for key, n in delta.items():
            if key.startswith("backward."):
                backward.launches[key.split(".", 1)[1]] += n
            else:
                _COUNTED[key].launches += n


def _tensors(tree, out: list) -> list:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


@dataclass
class _Captured:
    """One captured step: its graph, the input buffers it reads, its static
    outputs, the resident tensors' addresses and the counters' advance."""

    graph: object
    buffers: dict
    outputs: object
    addresses: list
    advance: dict


class StepGraph:
    """``fn`` captured as one CUDA graph per static shape of its inputs
    (see the module docstring)."""

    def __init__(self, fn, *, inputs: tuple[int, ...], counters: LaunchCounters | None = None):
        self.fn = fn
        self.inputs = frozenset(inputs)
        self.counters = counters or LaunchCounters()
        self._warm: set = set()
        self._captured: dict = {}

    def __call__(self, *args):
        if not self._uses_graphs(args):
            return self.fn(*args)
        key = tuple((tuple(args[i].shape), args[i].dtype) for i in sorted(self.inputs))
        cap = self._captured.get(key)
        if cap is None:
            if key not in self._warm:
                self._warm.add(key)
                return self._warm_up(args)
            cap = self._captured[key] = self._capture(args)
        if self._addresses(args) != cap.addresses:
            raise RuntimeError("a resident tensor of the captured step moved; callers "
                               "update weights, caches and pools in place")
        for i, buf in cap.buffers.items():
            buf.copy_(args[i])
        self._replay(cap.graph)
        self.counters.add(cap.advance)
        return cap.outputs

    def _addresses(self, args) -> list[int]:
        resident = [a for i, a in enumerate(args) if i not in self.inputs]
        return [t.data_ptr() for t in _tensors(resident, [])]

    def _capture(self, args) -> _Captured:
        buffers = {i: args[i].clone() for i in self.inputs}
        call = tuple(buffers.get(i, a) for i, a in enumerate(args))
        before = self.counters.read()
        graph, outputs = self._record(call)
        after = self.counters.read()
        advance = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.counters.add({k: -n for k, n in advance.items()})
        return _Captured(graph, buffers, outputs, self._addresses(args), advance)

    # -- the device, behind four methods (tests replace them) -----------

    @staticmethod
    def _uses_graphs(args) -> bool:
        return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)

    @staticmethod
    def _side_stream(args):
        """The device's one side stream for warm-ups and captures.  A stream
        on which a GEMM runs gets a cuBLAS workspace that the process keeps
        to its end, so a stream for each graph would leave a workspace on
        the card for every engine ever built (a router that replaces
        replicas builds many)."""
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        stream = _SIDE_STREAMS.get(device)
        if stream is None:
            stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
        return stream

    def _warm_up(self, args):
        stream = self._side_stream(args)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            out = self.fn(*args)
        torch.cuda.current_stream().wait_stream(stream)
        return out

    def _record(self, call):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._side_stream(call)):
            outputs = self.fn(*call)
        return graph, outputs

    @staticmethod
    def _replay(graph) -> None:
        graph.replay()
