"""Port parity of the data streams (``repro_torch.train.data``) and the
elastic control plane (``repro_torch.train.elastic``), on the CPU, against
the JAX package's: the same seeds, hosts, shard files and cursors give
equal batches and ``state()``; the same worker sets and heartbeats give
equal plans."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.train import data as ref_data  # noqa: E402
from repro.train import elastic as ref_elastic  # noqa: E402
from repro_torch.train import data, elastic  # noqa: E402


def _assert_batches_equal(a, b):
    for key in ("tokens", "labels"):
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("host_id,num_hosts", [(0, 1), (1, 2), (3, 4)])
def test_synthetic_matches_reference_per_host(host_id, num_hosts):
    kw = dict(seed=5, host_id=host_id, num_hosts=num_hosts)
    ref, port = ref_data.SyntheticLMData(512, 3, 17, **kw), data.SyntheticLMData(512, 3, 17, **kw)
    for _ in range(3):
        _assert_batches_equal(port.next_batch(), ref.next_batch())
    assert port.state() == ref.state() == {"step": 3, "seed": 5}


def test_synthetic_deterministic_resumable_and_sharded():
    d1 = data.SyntheticLMData(512, batch=4, seq_len=16, seed=3)
    batches = [d1.next_batch() for _ in range(5)]
    d2 = data.SyntheticLMData(512, batch=4, seq_len=16, seed=3)
    d2.restore({"step": 3, "seed": 3})
    _assert_batches_equal(d2.next_batch(), batches[3])
    np.testing.assert_array_equal(batches[0]["tokens"][:, 1:], batches[0]["labels"][:, :-1])
    a = data.SyntheticLMData(512, 2, 8, seed=0, host_id=0, num_hosts=2).next_batch()
    b = data.SyntheticLMData(512, 2, 8, seed=0, host_id=1, num_hosts=2).next_batch()
    assert not np.array_equal(a["tokens"], b["tokens"])


def _shards(tmp_path, sizes=(130, 200)):
    paths = []
    for i, n in enumerate(sizes):  # uneven shards
        p = str(tmp_path / f"shard{i}.bin")
        data.write_binary_shard(p, (np.arange(n) + 1000 * i).astype(np.uint16))
        paths.append(p)
    return paths


@pytest.mark.parametrize("batch,seq,host_id,num_hosts", [(1, 31, 0, 1), (2, 15, 1, 2)])
def test_binary_shards_match_reference_across_boundary_and_epoch(tmp_path, batch, seq, host_id,
                                                                 num_hosts):
    """Both readers walk the same shards across a shard boundary and an
    epoch wrap with equal batches and states; restoring any snapshot into a
    fresh port reader replays the rest of the stream."""
    paths = _shards(tmp_path)
    kw = dict(host_id=host_id, num_hosts=num_hosts)
    ref = ref_data.BinaryShardData(paths, batch, seq, **kw)
    port = data.BinaryShardData(paths, batch, seq, **kw)
    snaps, batches = [], []
    for _ in range(12):
        assert port.state() == ref.state()
        snaps.append(port.state())
        batches.append(port.next_batch())
        _assert_batches_equal(batches[-1], ref.next_batch())
    assert port.state()["epoch"] >= 1 and {s["shard_idx"] for s in snaps} == {0, 1}
    for k, snap in enumerate(snaps):
        ds = data.BinaryShardData(paths, batch, seq, **kw)
        ds.restore(snap)
        for want in batches[k:]:
            _assert_batches_equal(ds.next_batch(), want)


def test_binary_shard_file_and_state_helpers_match_reference(tmp_path):
    toks = np.random.default_rng(0).integers(0, 1000, size=4096).astype(np.uint16)
    data.write_binary_shard(str(tmp_path / "port" / "s.bin"), toks)
    ref_data.write_binary_shard(str(tmp_path / "ref" / "s.bin"), toks)
    assert (tmp_path / "port" / "s.bin").read_bytes() == (tmp_path / "ref" / "s.bin").read_bytes()
    ds = data.BinaryShardData([str(tmp_path / "port" / "s.bin")], batch=2, seq_len=15)
    b = ds.next_batch()
    np.testing.assert_array_equal(b["tokens"][0], toks[:15].astype(np.int32))
    np.testing.assert_array_equal(b["labels"][0], toks[1:16].astype(np.int32))
    data.save_data_state(str(tmp_path / "st.json"), ds.state())
    assert data.load_data_state(str(tmp_path / "st.json")) == ref_data.load_data_state(
        str(tmp_path / "st.json")) == ds.state()
    with pytest.raises(ValueError, match="no shard paths"):
        data.BinaryShardData([], 1, 4)


# ---------------------------------------------------------------------------
# The elastic control plane
# ---------------------------------------------------------------------------


def test_counter_schema_and_view_match_reference():
    assert elastic.COUNTER_KEYS == ref_elastic.COUNTER_KEYS
    src = {"rollbacks": 2, "not_a_counter": 9, "nan_skips": 0}
    assert elastic.counters_view(src) == ref_elastic.counters_view(src)
    assert tuple(elastic.counters_view({})) == elastic.COUNTER_KEYS


@pytest.mark.parametrize("num_shards,alive", [(10, [0, 2, 5]), (13, [4, 1, 3, 0]), (3, [7]),
                                              (4, [])])
def test_reassign_shards_matches_reference(num_shards, alive):
    if not alive:
        for mod in (elastic, ref_elastic):
            with pytest.raises(ValueError):
                mod.reassign_shards(num_shards, alive)
        return
    got = elastic.reassign_shards(num_shards, alive)
    assert got == ref_elastic.reassign_shards(num_shards, list(reversed(alive)))
    assert sorted(s for v in got.values() for s in v) == list(range(num_shards))


@pytest.mark.parametrize("n,mp,pods", [(512, 16, 2), (256, 16, 1), (240, 16, None), (96, 16, 4),
                                       (250, 16, None)])
def test_replan_mesh_matches_reference(n, mp, pods):
    outs = []
    for mod in (elastic, ref_elastic):
        try:
            outs.append(mod.replan_mesh(n, model_parallel=mp, pods=pods))
        except ValueError as e:
            outs.append(("raised", str(e)))
    assert outs[0] == outs[1]


STEP_TIMES = [{0: 1.0, 1: 1.1, 2: 5.0, 3: 0.9}, {0: 1.0, 1: 1.0, 2: 9.0, 3: 1.0},
              {0: 1.0, 1: 8.0, 2: 1.0, 3: 1.0}, {0: 1.0, 1: 9.0, 2: 9.0, 3: 1.0},
              {0: 1.0, 1: 9.0, 2: 1.0, 3: 1.0}, {}, {0: 1.0, 1: 9.0, 2: 9.0, 3: 1.0}]


def test_straggler_policy_and_tracker_match_reference():
    reports = []
    for mod in (elastic, ref_elastic):
        pol = mod.StragglerPolicy(threshold=2.0, patience=2)
        tr = mod.StragglerTracker(pol)
        out = [(pol.flag(t), tr.observe(t)) for t in STEP_TIMES]
        tr.forget(1)
        out.append(tr.observe(STEP_TIMES[3]))
        reports.append(out)
    assert reports[0] == reports[1]
    assert reports[0][1] == ([2], ([2], [2]))  # patience 2 reached


def test_failure_detector_matches_reference():
    """Beats and ticks through a cascading failure and a zombie heartbeat."""
    script = [("beat", 0), ("beat", 1), ("tick",), ("beat", 0), ("tick",), ("beat", 2),
              ("beat", 0), ("tick",), ("beat", 4), ("beat", 0), ("tick",), ("tick",)]
    logs = []
    for mod in (elastic, ref_elastic):
        det = mod.FailureDetector([0, 1, 2, 3, 4], max_missed=2)
        log = []
        for op in script:
            if op[0] == "beat":
                det.beat(op[1])
            else:
                log.append((det.tick(), det.alive))
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0][1] == ([1, 2, 3, 4], [0])
    assert all(not set(dead) & {2, 4} for dead, _ in logs[0][2:])  # zombies stay dead
