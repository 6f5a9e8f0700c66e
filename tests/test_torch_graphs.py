"""``repro_torch.serve.graphs``: on the CPU a ``StepGraph`` is the step
function itself; its capture bookkeeping (one eager warm-up, one capture,
then replays; inputs copied into owned buffers; resident tensors held at
their addresses; a capture's launch-count advance taken back and added
once per replay) runs here through a seam that replaces the four device
methods.  The engines keep every tensor a captured step reads at a fixed
address.  The card's own capture is tested in ``test_torch_cuda.py``."""
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import backward as bwd  # noqa: E402
from repro_torch.kernels import decode as dec  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402
from repro_torch.serve.engine import PagedServeEngine, ServeEngine  # noqa: E402
from repro_torch.serve.graphs import LaunchCounters, StepGraph  # noqa: E402
from repro_torch.serve.serve_step import make_decode_step  # noqa: E402


class FakeCounters:
    def __init__(self):
        self.n = {"decode": 0, "paged_decode": 0}

    def read(self):
        return dict(self.n)

    def add(self, delta):
        for k, v in delta.items():
            self.n[k] += v


CAPTURING = [False]  # a capture records the step's work and runs none of it


class FakeDeviceGraph(StepGraph):
    """StepGraph with the device replaced: capture runs the step's Python
    (so its wrappers count, as on the card) and keeps a replay that redoes
    the step's arithmetic on the captured buffers without counting, as a
    graph replay runs the kernels but no Python."""

    def __init__(self, fn, replay_fn, **kw):
        super().__init__(fn, **kw)
        self.replay_fn = replay_fn
        self.warm_ups = self.records = self.replays = 0

    @staticmethod
    def _uses_graphs(args):
        return True

    def _warm_up(self, args):
        self.warm_ups += 1
        return self.fn(*args)

    def _record(self, call):
        self.records += 1
        CAPTURING[0] = True
        try:
            outputs = self.fn(*call)
        finally:
            CAPTURING[0] = False
        return (call, outputs), outputs

    def _replay(self, graph):
        self.replays += 1
        call, outputs = graph
        self.replay_fn(outputs, *call)


def _step(counters):
    """A step over (weight, tokens, state): three decode launches and one
    paged launch a call (its wrappers count them); writes tokens · weight
    into a fresh output and accumulates tokens into ``state`` in place."""
    def step(w, tokens, state):
        for _ in range(3):
            counters.n["decode"] += 1
        counters.n["paged_decode"] += 1
        if CAPTURING[0]:
            return torch.empty_like(tokens), state
        state.add_(tokens)
        return tokens * w, state
    return step


def _replay(outputs, w, tokens, state):
    outputs[0].copy_(tokens * w)
    state.add_(tokens)


def test_step_graph_on_the_cpu_is_the_eager_function():
    calls = []

    def fn(*args):
        calls.append(args)
        return ("out", len(calls))

    g = StepGraph(fn, inputs=(1,))
    x, w = torch.arange(4), torch.ones(2)
    assert g(w, x) == ("out", 1)
    assert g(w, x) == ("out", 2)
    assert all(a[0] is w and a[1] is x for a in calls)  # the caller's tensors, not copies
    assert not g._captured and not g._warm

    # The real slot decode step: StepGraph on CPU tensors gives the eager
    # step's results bit for bit.
    cfg = get_config("starcoder2-7b", reduced=True)
    params = lm.init_params(cfg, device="cpu")
    caches = [kv_cache.init_cache(cfg, 2, 32, device="cpu") for _ in range(2)]
    toks = torch.tensor([[3], [5]])
    pos = torch.tensor([0, 4], dtype=torch.int32)
    eager = make_decode_step(cfg)(params, toks, caches[0], pos)
    graphed = StepGraph(make_decode_step(cfg), inputs=(1, 3))(params, toks, caches[1], pos)
    assert torch.equal(eager[0], graphed[0])
    assert all(torch.equal(eager[1][k], graphed[1][k]) for k in eager[1])
    assert graphed[1] is caches[1]  # written in place, length too
    assert caches[1]["length"].tolist() == [1, 5]


def test_capture_bookkeeping_counts_each_replay_once_and_never_the_capture():
    counters = FakeCounters()
    g = FakeDeviceGraph(_step(counters), _replay, inputs=(1,), counters=counters)
    w, state = torch.tensor(2), torch.zeros(3, dtype=torch.int64)

    out, st = g(w, torch.tensor([1, 2, 3]), state)  # warm-up: eager, counted by its wrappers
    assert (g.warm_ups, g.records, g.replays) == (1, 0, 0)
    assert counters.n == {"decode": 3, "paged_decode": 1}
    assert out.tolist() == [2, 4, 6] and st is state

    out, st = g(w, torch.tensor([4, 5, 6]), state)  # capture, then one replay
    assert (g.warm_ups, g.records, g.replays) == (1, 1, 1)
    assert counters.n == {"decode": 6, "paged_decode": 2}
    assert out.tolist() == [8, 10, 12]
    first = out
    for i in range(3):  # replays only
        tokens = torch.tensor([i, i, i])
        out, st = g(w, tokens, state)
        assert out is first  # the graph's static output, overwritten each replay
        assert out.tolist() == [2 * i] * 3
    assert (g.warm_ups, g.records, g.replays) == (1, 1, 4)
    assert counters.n == {"decode": 3 * 5, "paged_decode": 5}
    assert state.tolist() == [1 + 4 + 0 + 1 + 2, 2 + 5 + 0 + 1 + 2, 3 + 6 + 0 + 1 + 2]
    # The input was copied into the graph's own buffer, not read in place.
    buf = next(iter(g._captured.values())).buffers[1]
    assert buf is not tokens and buf.tolist() == tokens.tolist()

    # A new input shape: its own warm-up and capture.
    g(w, torch.tensor([1, 1]), torch.zeros(2, dtype=torch.int64))
    g(w, torch.tensor([1, 1]), torch.zeros(2, dtype=torch.int64)[:2])
    assert (g.warm_ups, g.records) == (2, 2)


def test_a_moved_resident_tensor_raises():
    counters = FakeCounters()
    g = FakeDeviceGraph(_step(counters), _replay, inputs=(1,), counters=counters)
    w, state = torch.tensor(2), torch.zeros(3, dtype=torch.int64)
    x = torch.tensor([1, 2, 3])
    g(w, x, state)
    g(w, x, state)
    with pytest.raises(RuntimeError, match="moved"):
        g(w, x, state.clone())
    with pytest.raises(RuntimeError, match="moved"):
        g(torch.tensor(2), x, state)


def test_launch_counters_read_and_advance_the_kernel_modules():
    c = LaunchCounters()
    before = c.read()
    assert {"flash_attention", "distr_attention", "decode", "paged_decode", "ssd",
            "backward.delta", "backward.flash_dq", "backward.distr_dkv"} <= set(before)
    c.add({"decode": 2, "backward.delta": 1})
    try:
        assert dec.launches == before["decode"] + 2
        assert bwd.launches["delta"] == before["backward.delta"] + 1
    finally:
        c.add({"decode": -2, "backward.delta": -1})
    assert c.read() == before


def _addresses(tree):
    if isinstance(tree, torch.Tensor):
        return [tree.data_ptr()]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _addresses(tree[k])]
    return []


@pytest.mark.parametrize("arch,fused", [
    pytest.param("starcoder2-7b", False, id="starcoder2-7b"),
    pytest.param("starcoder2-7b", True, id="starcoder2-7b-fused_k"),
    pytest.param("zamba2-7b", False, id="zamba2-7b"),
])
def test_slot_engine_keeps_what_a_captured_step_reads_in_place(arch, fused):
    """After the first step (which may widen a conv cache), the cache, pos
    and tokens a captured decode step reads never move; the fused-K̂ cache
    is written in place at every step, and raw K then only at admission."""
    cfg = get_config(arch, reduced=True)
    if fused:
        cfg = cfg.replace(attention=replace(cfg.attention, distr_decode=True))
    eng = ServeEngine(cfg, lm.init_params(cfg, device="cpu"), max_slots=2, max_len=64,
                      device="cpu")
    for prompt in ([1, 2, 3], [4, 5, 6, 7, 8], [9, 9]):
        eng.add_request(prompt, max_new_tokens=4)
    eng.step()
    seen = (_addresses(eng.cache), eng.pos.data_ptr(), eng.tokens.data_ptr())
    assert ("k_fused" in eng.cache) == fused
    while eng.active or eng.pending:
        before = {k: t.clone() for k, t in eng.cache.items()}
        admitting = bool(eng.pending) and len(eng.active) < eng.max_slots
        eng.step()
        assert (_addresses(eng.cache), eng.pos.data_ptr(), eng.tokens.data_ptr()) == seen
        if fused and eng.active:
            assert not torch.equal(eng.cache["k_fused"], before["k_fused"])
            if not admitting:
                assert torch.equal(eng.cache["k"], before["k"])
    assert [r.status for r in eng.finished] == ["done"] * 3


def test_paged_engine_fills_its_step_buffers_in_place():
    cfg = get_config("starcoder2-7b", reduced=True)
    eng = PagedServeEngine(cfg, lm.init_params(cfg, device="cpu"), max_batch=2, max_len=64,
                           block_size=16, prefill_chunk=8, device="cpu")
    seen = (_addresses(eng._tick_in), _addresses(eng._chunk_in), _addresses(eng.cache.pools))
    for prompt in ([1, 2, 3], list(range(1, 20)), [7] * 9):
        eng.add_request(prompt, max_new_tokens=5)
    eng.run_to_completion()
    assert (_addresses(eng._tick_in), _addresses(eng._chunk_in),
            _addresses(eng.cache.pools)) == seen
    assert [r.status for r in eng.finished] == ["done"] * 3


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_engine_frees_its_weights_without_the_cycle_collector(kind, monkeypatch):
    """An engine that served requests through captured steps holds its
    weights, caches and graphs in no reference cycle: with the collector
    off, dropping the engine and the caller's weights frees them (on the
    card, their memory) at once."""
    import gc
    import weakref

    from repro_torch.serve import graphs

    def record(self, call):
        return (self.fn, call, self.fn(*call)), self.fn(*call)

    def replay(graph):
        fn, call, outputs = graph
        for dst, src in zip(graphs._tensors(outputs, []), graphs._tensors(fn(*call), [])):
            dst.copy_(src)

    monkeypatch.setattr(StepGraph, "_uses_graphs", staticmethod(lambda args: True))
    monkeypatch.setattr(StepGraph, "_warm_up", lambda self, args: self.fn(*args))
    monkeypatch.setattr(StepGraph, "_record", record)
    monkeypatch.setattr(StepGraph, "_replay", staticmethod(replay))
    cfg = get_config("starcoder2-7b", reduced=True)
    gc.collect()
    gc.disable()
    try:
        params = lm.init_params(cfg, device="cpu")
        if kind == "slot":
            eng = ServeEngine(cfg, params, max_slots=2, max_len=64, device="cpu")
        else:
            eng = PagedServeEngine(cfg, params, max_batch=2, max_len=64, block_size=16,
                                   prefill_chunk=8, device="cpu")
        for prompt in ([1, 2, 3], list(range(1, 20)), [7] * 9):
            eng.add_request(prompt, max_new_tokens=6)
        assert [r.status for r in eng.run_to_completion()] == ["done"] * 3
        held = [weakref.ref(t) for t in (*lm.trainable(params), *graphs._tensors(
            eng.cache.pools if kind == "paged" else eng.cache, []))]
        engine = weakref.ref(eng)
        del eng, params
        assert engine() is None
        assert all(ref() is None for ref in held)
    finally:
        gc.enable()
