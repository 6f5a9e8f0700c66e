"""Port parity of the training supervisor (``repro_torch.train.supervisor``)
and of the launchers' ``--supervise`` and ``--ckpt``, on the CPU, against
the JAX package.

The supervisor half of the reference's train chaos suite over a fake
trainer with instant steps, each case run through both packages'
``TrainSupervisor`` tick for tick: the same live workers, mesh plan, shard
assignment, trainer step and restores after every tick, the same events,
counters, trace events and ``train_registry`` snapshot.  Then the port's
``Trainer`` under the port's supervisor beside the reference's ``Trainer``
under the reference's (the reference's weights carried across, the same
data seed, fault specs and step clocks): equal counters, steps, mesh,
shards and trace events, losses within 1e-5, and the supervised run's
losses bit-identical to an uninterrupted run of the port's Trainer.  Last,
``launch/train.py --supervise 2 --metrics-out`` and ``launch/serve.py
--ckpt`` on a checkpoint the port's Trainer wrote, through ``main``, their
snapshots checked by ``python -m repro_torch.obs.validate``, and the loaded
weights serving the trainer's own logits.
"""
import json
import os
import subprocess
import sys
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import faults as ref_faults  # noqa: E402
from repro import obs as ref_obs  # noqa: E402
from repro.train import elastic as ref_elastic  # noqa: E402
from repro.train import supervisor as ref_supervisor  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import validate  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import elastic, supervisor  # noqa: E402
from repro_torch.train.elastic import COUNTER_KEYS  # noqa: E402

from test_torch_train_chaos import (  # noqa: E402,F401
    StepClock,
    _make_trainer,
    _pair_trainers,
    ref_weights,
)
from _torch_helpers import one_intra_op_thread  # noqa: E402,F401

REF = SimpleNamespace(name="ref", supervisor=ref_supervisor, elastic=ref_elastic,
                      faults=ref_faults, obs=ref_obs)
PORT = SimpleNamespace(name="port", supervisor=supervisor, elastic=elastic, faults=faults,
                       obs=obs)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


class FakeTrainer:
    """The Trainer surface the supervisor drives, with instant steps and an
    in-memory checkpoint at every ``ckpt_every``-th step."""

    def __init__(self, ckpt_every=5, stuck=False):
        self.step = 0
        self.counters = Counter()
        self.history = []
        self.ckpt_every = ckpt_every
        self.stuck = stuck
        self._ckpt_step = 0
        self.restores = []

    def step_once(self):
        if self.stuck:  # every step consumed by a rollback
            return None
        self.step += 1
        rec = {"step": self.step, "loss": 1.0, "sec": 0.1 * self.step}
        self.history.append(rec)
        if self.step % self.ckpt_every == 0:
            self._ckpt_step = self.step
        return rec

    def restore_from_checkpoint(self, *, restore_data=True):
        self.restores.append(self.step)
        self.step = self._ckpt_step
        self.history = [r for r in self.history if r["step"] <= self.step]
        return self.step

    def counters_snapshot(self):
        return elastic.counters_view(self.counters)


# Each case: supervisor settings, fault specs, steps to run, the trainer's
# checkpoint interval, and the exception the run ends with (None: none).
CASES = {
    "healthy": dict(kw=dict(num_workers=4), specs=[], steps=10),
    "worker_loss": dict(kw=dict(num_workers=4, max_missed=2),
                        specs=[dict(point="worker_loss", uid=2, after=6, times=-1)], steps=12),
    "straggler": dict(kw=dict(num_workers=4, max_missed=2, policy=(2.0, 2)), ckpt_every=4,
                      specs=[dict(point="slow_worker", uid=1, times=-1, delay=9.0)], steps=12),
    "slow_default_delay": dict(kw=dict(num_workers=3, max_missed=2, policy=(3.0, 3)),
                               specs=[dict(point="slow_worker", uid=0, after=2, times=-1)],
                               steps=9),
    "two_losses": dict(kw=dict(num_workers=5, max_missed=3, num_shards=7),
                       specs=[dict(point="worker_loss", uid=0, after=2, times=-1),
                              dict(point="worker_loss", uid=4, after=8, times=-1)], steps=14),
    # chip_smoke.py's supervisor phase: a loss and a straggler's exclusion
    # on the same tick, one remesh and one restore.
    "card_schedule": dict(kw=dict(num_workers=4, max_missed=2, policy=(2.0, 2)), ckpt_every=3,
                          specs=[dict(point="worker_loss", uid=2, after=4, times=-1),
                                 dict(point="slow_worker", uid=1, after=3, times=-1, delay=9.0)],
                          steps=5),
    "obs_worker_loss": dict(kw=dict(num_workers=3, max_missed=2),
                            specs=[dict(point="worker_loss", uid=1, after=3, times=-1)],
                            steps=8),
    "no_survivors": dict(kw=dict(num_workers=3, max_missed=1),
                         specs=[dict(point="worker_loss", times=-1)], steps=5,
                         raises="NoSurvivorsError"),
    "tick_budget": dict(kw=dict(num_workers=2), specs=[], steps=5, max_ticks=7, stuck=True,
                        raises="RuntimeError"),
}


def _supervise(pkg, case) -> dict:
    """Run one case in one package, one tick at a time, and record every
    decision the supervisor made after each tick."""
    ft = FakeTrainer(ckpt_every=case.get("ckpt_every", 5), stuck=case.get("stuck", False))
    kw = dict(case["kw"])
    if "policy" in kw:
        threshold, patience = kw.pop("policy")
        kw["straggler_policy"] = pkg.elastic.StragglerPolicy(threshold=threshold,
                                                             patience=patience)
    rec = pkg.obs.TraceRecorder(clock=StepClock())
    inj = pkg.faults.FaultInjector([pkg.faults.FaultSpec(**s) for s in case["specs"]])
    sup = pkg.supervisor.TrainSupervisor(ft, faults=inj, trace=rec, **kw)
    ticks, raised = [], None
    orig_tick = sup.tick

    def tick():
        try:
            return orig_tick()
        finally:
            ticks.append((sup.ticks, list(sup.alive), sorted(sup.lost), sup.mesh_plan,
                          {w: list(s) for w, s in sup.shard_assignment.items()}, ft.step))

    sup.tick = tick
    try:
        sup.run(case["steps"], max_ticks=case.get("max_ticks"))
    except Exception as e:  # noqa: BLE001 - the case names the one it expects
        raised = type(e).__name__
    return {"ticks": ticks, "raised": raised, "events": sup.events,
            "counters": sup.counters_snapshot(), "history": ft.history,
            "restores": ft.restores, "trace": rec.to_chrome(),
            "registry": pkg.obs.train_registry(sup).snapshot(),
            "num_shards": sup.num_shards}


@pytest.mark.parametrize("name", list(CASES))
def test_supervisor_matches_reference_tick_for_tick(name):
    case = CASES[name]
    want = _supervise(REF, case)
    got = _supervise(PORT, case)
    assert got == want
    assert got["raised"] == case.get("raises")
    assert validate.validate_metrics_snapshot(json.loads(json.dumps(got["registry"]))) == []
    assert validate.validate_chrome_trace(json.loads(json.dumps(got["trace"]))) == []
    kinds = [e["kind"] for e in got["events"]]
    snap = got["counters"]
    if name == "healthy":
        assert kinds == [] and len(got["ticks"]) == 10 and not any(snap.values())
        assert got["ticks"][-1][3] == ((4, 1), ("data", "model"))
    elif name == "worker_loss":
        # worker 2 stops beating on tick 7 and crosses max_missed=2 that
        # tick, so the restore lands at step 6 and rewinds to step 5.
        assert kinds == ["worker_loss", "remesh"] and got["restores"] == [6]
        assert snap["worker_deaths"] == snap["remesh_events"] == 1
        last = got["ticks"][-1]
        assert last[1] == [0, 1, 3] and last[3] == ((3, 1), ("data", "model"))
        assert sorted(s for v in last[4].values() for s in v) == list(range(8))
        assert [r["step"] for r in got["history"]] == list(range(1, 13))
    elif name == "straggler":
        assert kinds == ["straggler_excluded", "remesh"] and snap["straggler_flags"] >= 2
        assert got["ticks"][-1][1] == [0, 2, 3]
    elif name == "obs_worker_loss":
        names = [e["name"] for e in got["trace"]["traceEvents"]]
        assert "worker_loss" in names and "remesh" in names
    elif name == "card_schedule":
        assert kinds == ["worker_loss", "straggler_excluded", "remesh"]
        assert {k: v for k, v in snap.items() if v} == {
            "worker_deaths": 2, "remesh_events": 1, "straggler_flags": 2}
        assert got["restores"] == [4] and got["events"][-1]["restored_step"] == 3
        assert got["ticks"][-1][1] == [0, 3] and len(got["ticks"]) == 6
    elif name == "slow_default_delay":  # no delay given: 4x the base step time
        assert kinds == ["straggler_excluded", "remesh"] and got["ticks"][-1][1] == [1, 2]
    elif name == "tick_budget":
        assert len(got["ticks"]) == 7


def test_supervisor_surface_matches_reference():
    """The frozen schema, the constructor's refusal of an empty worker set,
    a snapshot that merges the trainer's counters, and the default plan."""
    assert elastic.COUNTER_KEYS == ref_elastic.COUNTER_KEYS
    for pkg in (REF, PORT):
        with pytest.raises(ValueError):
            pkg.supervisor.TrainSupervisor(FakeTrainer(), num_workers=0)
    snaps = []
    for pkg in (REF, PORT):
        ft = FakeTrainer()
        ft.counters["nan_skips"] = 2
        sup = pkg.supervisor.TrainSupervisor(ft, num_workers=2)
        sup.counters["remesh_events"] = 1
        snaps.append((sup.counters_snapshot(), sup.mesh_plan, sup.num_shards, sup.alive))
    assert snaps[0] == snaps[1]
    assert tuple(snaps[1][0]) == COUNTER_KEYS
    assert snaps[1][0]["nan_skips"] == 2 and snaps[1][0]["remesh_events"] == 1
    assert issubclass(supervisor.NoSurvivorsError, RuntimeError)


# ---------------------------------------------------------------------------
# The port's Trainer under supervision, beside the reference's
# ---------------------------------------------------------------------------


def test_supervised_trainer_matches_reference_and_an_uninterrupted_run(ref_weights, tmp_path):
    """Worker 2 lost after its 7th heartbeat, 4 workers, max_missed 2,
    checkpoints every 5 steps: both packages remesh to 3 workers and
    restore from the step-5 checkpoint; equal counters, history steps,
    events, plans, shard assignments and trace events, losses within 1e-5;
    the port's losses equal an uninterrupted port run's exactly."""
    specs = [dict(point="worker_loss", uid=2, after=7, times=-1)]
    ref, port = _pair_trainers(ref_weights, tmp_path, [], ckpt_every=5)
    sups = {}
    for pkg, tr in ((REF, ref), (PORT, port)):
        inj = pkg.faults.FaultInjector([pkg.faults.FaultSpec(**s) for s in specs])
        sups[pkg.name] = pkg.supervisor.TrainSupervisor(tr, num_workers=4, max_missed=2,
                                                        faults=inj, trace=tr.trace,
                                                        clock=tr.clock)
        sups[pkg.name].run(10)
    rs, ps = sups["ref"], sups["port"]
    assert ps.counters_snapshot() == rs.counters_snapshot()
    assert ps.counters_snapshot()["worker_deaths"] == ps.counters_snapshot()["remesh_events"] == 1
    assert (ps.alive, ps.mesh_plan, ps.shard_assignment) == (rs.alive, rs.mesh_plan,
                                                             rs.shard_assignment)
    assert ps.alive == [0, 1, 3]
    assert ps.events == rs.events
    assert [e["restored_step"] for e in ps.events if e["kind"] == "remesh"] == [5]
    assert [r["step"] for r in port.history] == [r["step"] for r in ref.history] == list(
        range(1, 11))
    for a, b in zip(port.history, ref.history):
        assert a["loss"] == pytest.approx(b["loss"], abs=1e-5, rel=1e-5)
    want = [(e["name"], e["ph"], e["t"], e["args"]) for e in ref.trace.events]
    got = [(e["name"], e["ph"], e["t"], e["args"]) for e in port.trace.events]
    assert got == want
    _, plain = _pair_trainers(ref_weights, tmp_path / "plain", [], ckpt_every=5)
    for _ in range(10):
        plain.step_once()
    assert [(r["step"], r["loss"]) for r in port.history] == [
        (r["step"], r["loss"]) for r in plain.history]


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------


def _validate_cli(metrics, trace=None):
    env = dict(os.environ, PYTHONPATH=SRC)
    argv = [sys.executable, "-m", "repro_torch.obs.validate", "--metrics", metrics]
    if trace:
        argv += ["--trace", trace]
    return subprocess.run(argv, capture_output=True, text=True, env=env, timeout=120)


def test_launch_train_supervise_and_serve_ckpt(tmp_path, capsys):
    """``launch.train --supervise 2`` wraps the trainer (the snapshot reads
    the supervisor: every frozen key, the trainer's step), and
    ``launch.serve --ckpt`` serves the newest verified checkpoint that run
    wrote: the loaded weights equal the trainer's, the served tokens equal
    those of a slot engine over the trainer's own weights, and both
    snapshots and the trace pass the validator."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    w, m, t = str(tmp_path / "w"), str(tmp_path / "m.json"), str(tmp_path / "t.json")
    out = train.main(["--arch", "minicpm-2b", "--reduced", "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--workdir", w, "--ckpt-every", "3",
                      "--supervise", "2", "--trace", t, "--metrics-out", m])
    sup = out["supervisor"]
    assert isinstance(sup, supervisor.TrainSupervisor) and sup.trainer is out["trainer"]
    assert sup.alive == [0, 1] and sup.ticks == 3
    assert "[train] supervisor counters:" in capsys.readouterr().out
    res = _validate_cli(m, t)
    assert res.returncode == 0 and "conform" in res.stdout, res.stdout + res.stderr
    snap = json.loads(open(m).read())
    assert {f"train_{k}" for k in COUNTER_KEYS} <= set(snap["counters"])
    assert snap["gauges"]["train_step"] == 3
    ckpt_dir = os.path.join(w, "checkpoints")
    assert ckpt.latest_verified_name(ckpt_dir) == "step_00000003"

    cfg = get_config("minicpm-2b", reduced=True)
    loaded = serve.load_params(cfg, ckpt_dir, device="cpu")
    trained = out["trainer"].params
    for (name, a), (_, b) in zip(lm.named_trainable(loaded), lm.named_trainable(trained)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    m2 = str(tmp_path / "m2.json")
    got = serve.main(["--arch", "minicpm-2b", "--reduced", "--device", "cpu", "--ckpt",
                      ckpt_dir, "--prompt-lens", "5,9", "--max-new", "4", "--max-len", "64",
                      "--metrics-out", m2])
    assert "weights from step_00000003" in capsys.readouterr().out
    res = _validate_cli(m2)
    assert res.returncode == 0 and "conform" in res.stdout, res.stdout + res.stderr
    eng = ServeEngine(cfg, trained, max_slots=4, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    for n in (5, 9):
        eng.add_request(rng.integers(1, cfg.vocab, size=n).tolist(), max_new_tokens=4)
    want = {r.uid: r.generated for r in eng.run_to_completion()}
    assert {r.uid: r.generated for r in got["done"]} == want


def test_serve_ckpt_refuses_a_directory_with_no_verified_checkpoint(tmp_path):
    """``--ckpt`` verifies: a directory whose only checkpoint is torn
    raises, and so does an empty one."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    tr = _make_trainer(str(tmp_path / "w"), ckpt_every=100,
                       faults=faults.FaultInjector([faults.FaultSpec("ckpt_torn_write")]))
    assert tr.step == 0
    cfg = get_config("minicpm-2b", reduced=True)
    with pytest.raises(ckpt.CheckpointCorrupt):
        serve.load_params(cfg, tr.ckpt_dir, device="cpu")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        serve.load_params(cfg, str(tmp_path / "empty"), device="cpu")
