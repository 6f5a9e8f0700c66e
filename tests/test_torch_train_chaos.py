"""Train-side chaos suite of the port, on the CPU: verified checkpoints,
the anomaly guard and every recovery path of ``repro_torch.train.trainer``,
driven fault by fault through the shared injector (``faults.TRAIN_POINTS``).

The pure parts side by side with the JAX package's (the catalogs, the
anomaly detector on the same streams); the checkpoint contract of the
reference's chaos suite on the port's format (npz of each tensor's key
path, bf16 as its bits, loads in place); every recovery path of the port's
Trainer on minicpm-2b ``reduced()`` (batch 2, seq 16): spike rollback,
persistent-spike halt, torn resume, NaN skip and halt, the emergency save
and its failure, bit-exact resume against an uninterrupted run, and a
corrupt data shard caught by the guard; and the port's Trainer beside the
reference's Trainer (its weights carried across, the same data seed and
fault specs): equal counters, history steps, trace events and, within
1e-5, losses.  The other comparisons with the reference's Trainer are
``slow``: each jits a reference step.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import faults as ref_faults  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import lsh as ref_lsh  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.obs import TraceRecorder as RefTraceRecorder  # noqa: E402
from repro.train import anomaly as ref_anomaly  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro.train.data import SyntheticLMData as RefSyntheticLMData  # noqa: E402
from repro.train.optimizer import OptimizerConfig as RefOptimizerConfig  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.faults import FaultInjector, FaultSpec  # noqa: E402
from repro_torch.launch.train import init_train_params  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.obs import TraceRecorder, train_registry  # noqa: E402
from repro_torch.train import anomaly  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.anomaly import AnomalyConfig, AnomalyDetector, AnomalyHalt  # noqa: E402
from repro_torch.train.data import SyntheticLMData  # noqa: E402
from repro_torch.train.elastic import COUNTER_KEYS  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from _torch_helpers import one_intra_op_thread  # noqa: E402,F401

ARCH = "minicpm-2b"


# ---------------------------------------------------------------------------
# The catalogs and the anomaly detector against the reference's
# ---------------------------------------------------------------------------


def test_train_catalog_and_spike_default_match_reference():
    assert faults.TRAIN_POINTS == ref_faults.TRAIN_POINTS
    assert set(faults.TRAIN_POINTS) == {"ckpt_torn_write", "nan_grad", "loss_spike",
                                        "worker_loss", "slow_worker", "data_shard_corrupt"}
    from repro_torch.train import trainer as port_trainer

    assert port_trainer.DEFAULT_SPIKE_SCALE == ref_trainer.DEFAULT_SPIKE_SCALE
    assert AnomalyConfig() == AnomalyConfig(**vars(ref_anomaly.AnomalyConfig()))
    assert str(AnomalyHalt(7, 2, "x")) == str(ref_anomaly.AnomalyHalt(7, 2, "x"))
    batch = {"tokens": np.arange(12).reshape(2, 6), "labels": np.arange(12).reshape(2, 6)}
    np.testing.assert_array_equal(port_trainer._scramble_labels(batch, 5, 97)["labels"],
                                  ref_trainer._scramble_labels(batch, 5, 97)["labels"])


_CFG = dict(warmup=5, z_threshold=4.0, min_rel_increase=0.25)
_JITTER = [0.0, 0.01, -0.01, 0.02, -0.02]
STREAMS = {
    "spike": [(1.0 + _JITTER[i % 5], 1.0 + _JITTER[(i + 2) % 5]) for i in range(12)]
    + [(10.0, 1.0), (10.0, 1.0), (1.0, 1.0)],
    "warmup": [(1.0, 1.0)] * 3 + [(50.0, 1.0)],
    "one_sided": [(1.0 + _JITTER[i % 5], 1.0) for i in range(12)] + [(0.01, 1.0)],
    "plateau": [(1.0, 1.0)] * 10 + [(1.1, 1.0), (1.5, 1.0)],
    "grad_norm": [(1.0 + _JITTER[i % 5], 1.0 + _JITTER[(i + 2) % 5]) for i in range(12)]
    + [(1.0, 25.0)],
    "drift": [(5.0 - 0.1 * i, 2.0 + 0.3 * (i % 3)) for i in range(30)] + [(40.0, 90.0)],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("enabled", [True, False])
def test_anomaly_detector_matches_reference(name, enabled):
    """The same streams through both detectors: equal reports, step by
    step; a flagged sample is not absorbed into the statistics."""
    reports = []
    for mod in (anomaly, ref_anomaly):
        det = mod.AnomalyDetector(mod.AnomalyConfig(enabled=enabled, **_CFG))
        reports.append([det.update(loss, g) for loss, g in STREAMS[name]])
    assert reports[0] == reports[1]
    flagged = [i for i, r in enumerate(reports[0]) if r is not None]
    if not enabled:
        assert flagged == []
    elif name == "spike":
        assert flagged == [12, 13] and reports[0][12]["loss_z"] > 4.0
    elif name == "plateau":
        assert flagged == [11]  # +10% is under min_rel_increase, +50% is not
    elif name == "grad_norm":
        assert list(reports[0][12]) == ["grad_norm_z"]
    elif name in ("warmup", "one_sided"):
        assert flagged == []


# ---------------------------------------------------------------------------
# The checkpoint contract on the port's format
# ---------------------------------------------------------------------------


def _tiny_params(shift=0.0):
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) + shift,
            "b": torch.full((3,), shift)}


def _zeros():
    return {"w": torch.zeros(2, 3), "b": torch.zeros(3)}


def _torn(uid=None, times=1):
    return FaultInjector([FaultSpec("ckpt_torn_write", uid=uid, times=times)])


def test_manifest_written_and_verifies(tmp_path):
    path = ckpt.save_checkpoint(str(tmp_path), 7, _tiny_params())
    assert os.path.exists(os.path.join(path, ckpt.MANIFEST_NAME))
    assert ckpt.verify_checkpoint(path) == []
    assert ckpt.latest_verified_name(str(tmp_path)) == "step_00000007"
    assert sorted(os.listdir(path)) == ["manifest.json", "meta.json", "params.npz"]


def test_verify_catches_bit_flip(tmp_path):
    path = ckpt.save_checkpoint(str(tmp_path), 1, _tiny_params())
    ppath = os.path.join(path, "params.npz")
    with open(ppath, "r+b") as f:
        f.seek(os.path.getsize(ppath) - 20)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    assert ckpt.verify_checkpoint(path) and not ckpt.is_verified(path)


def test_injected_torn_write_fails_verification(tmp_path):
    path = ckpt.save_checkpoint(str(tmp_path), 3, _tiny_params(), faults=_torn())
    assert not ckpt.is_verified(path)
    assert os.path.exists(os.path.join(path, "meta.json"))  # it looks complete


def test_resume_falls_back_over_torn_latest(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _tiny_params(1.0), keep=10)
    ckpt.save_checkpoint(d, 2, _tiny_params(2.0), keep=10)
    ckpt.save_checkpoint(d, 3, _tiny_params(3.0), keep=10, faults=_torn(uid=3))
    target = _zeros()
    step, params, _, meta = ckpt.load_checkpoint(d, target)
    assert step == 2 and params is target
    assert meta["_fallback_skipped"] == 1 and meta["_name"] == "step_00000002"
    torch.testing.assert_close(target["b"], torch.full((3,), 2.0), atol=0, rtol=0)


def test_explicit_corrupt_step_raises(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _tiny_params(), keep=10)
    ckpt.save_checkpoint(d, 2, _tiny_params(), keep=10, faults=_torn(uid=2))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.load_checkpoint(d, _zeros(), step=2)
    assert ckpt.load_checkpoint(d, _zeros(), step=1)[0] == 1


def test_all_corrupt_raises(tmp_path):
    d = str(tmp_path)
    inj = _torn(times=-1)
    for s in (1, 2, 3):
        ckpt.save_checkpoint(d, s, _tiny_params(), keep=10, faults=inj)
    with pytest.raises(ckpt.CheckpointCorrupt, match="no verified checkpoint"):
        ckpt.load_checkpoint(d, _zeros())
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "none"), _zeros())


def test_gc_never_deletes_last_verified(tmp_path):
    """keep=2 would drop step 10, but it is the only one that verifies."""
    d = str(tmp_path)
    inj = FaultInjector([FaultSpec("ckpt_torn_write", after=1, times=-1)])
    for s in (10, 20, 30, 40):
        ckpt.save_checkpoint(d, s, _tiny_params(), keep=2, faults=inj)
    assert ckpt.list_checkpoints(d) == [10, 30, 40]
    assert ckpt.latest_verified_name(d) == "step_00000010"
    step, _, _, meta = ckpt.load_checkpoint(d, _zeros())
    assert step == 10 and meta["_fallback_skipped"] == 2


def test_tagged_save_never_clobbers_and_untagged_preferred(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 5, _tiny_params(), data_state={"step": 1}, keep=10)
    ckpt.save_checkpoint(d, 5, _tiny_params(), data_state={"step": 2}, keep=10, tag="emergency")
    assert ckpt.list_checkpoint_names(d) == ["step_00000005-emergency", "step_00000005"]
    step, _, _, meta = ckpt.load_checkpoint(d, _zeros())
    assert step == 5 and meta["_name"] == "step_00000005" and meta["data_state"] == {"step": 1}
    with pytest.raises(ValueError, match="filename-safe"):
        ckpt.checkpoint_name(5, tag="not/safe")


def test_verify_false_loads_pre_manifest_checkpoint(tmp_path):
    d = str(tmp_path)
    path = ckpt.save_checkpoint(d, 4, _tiny_params(4.0))
    os.remove(os.path.join(path, ckpt.MANIFEST_NAME))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.load_checkpoint(d, _zeros())
    target = _zeros()
    assert ckpt.load_checkpoint(d, target, verify=False)[0] == 4
    torch.testing.assert_close(target["b"], torch.full((3,), 4.0), atol=0, rtol=0)


def test_names_and_digests_match_reference(tmp_path):
    """The same step and tags give the same directory names, and an f32
    tensor's manifest digest equals the reference's for the same array."""
    for s, tag in ((0, ""), (12, "emergency"), (7, "anomaly-halt")):
        assert ckpt.checkpoint_name(s, tag) == ref_ckpt.checkpoint_name(s, tag)
    port = ckpt.save_checkpoint(str(tmp_path / "p"), 3, _tiny_params(1.5))
    ref = ref_ckpt.save_checkpoint(str(tmp_path / "r"), 3,
                                   {k: v.numpy() for k, v in _tiny_params(1.5).items()})
    import json

    def arrays(path):
        with open(os.path.join(path, ckpt.MANIFEST_NAME)) as f:
            return json.load(f)["arrays"]

    assert arrays(port) == arrays(ref)


def test_model_state_roundtrip_in_place_with_bf16_and_aliases(tmp_path):
    """A model's params and AdamW state round-trip bit-exactly into other
    tensors, in place: each target keeps its storage (an alias of a leaf
    sees the loaded values), bf16 leaves go through their bits, and a
    tied embedding is one array."""
    cfg = get_config(ARCH, reduced=True)
    src = init_train_params(cfg, seed=0, device="cpu")
    src["blocks"][0]["attn"]["wq"]["w"] = src["blocks"][0]["attn"]["wq"]["w"].bfloat16()
    state = opt_mod.adamw_init(lm.trainable(src))
    for i, (m, v) in enumerate(zip(state["m"], state["v"])):
        m.normal_(generator=torch.Generator().manual_seed(i))
        v.uniform_(generator=torch.Generator().manual_seed(100 + i))
    state["count"] = 17
    path = ckpt.save_checkpoint(str(tmp_path), 9, src, state, {"step": 9, "seed": 0})
    import json

    with open(os.path.join(path, ckpt.MANIFEST_NAME)) as f:
        manifest = json.load(f)
    assert manifest["dtypes"]["params.npz"]["blocks/0/attn/wq/w"] == "bfloat16"
    assert not any(k.startswith("lm_head") for k in manifest["arrays"]["params.npz"])
    with np.load(os.path.join(path, "params.npz")) as npz:
        assert npz["blocks/0/attn/wq/w"].dtype == np.uint16
        assert list(npz.files) == [n for n, _ in lm.named_trainable(src)]

    dst = init_train_params(cfg, seed=1, device="cpu")
    dst["blocks"][0]["attn"]["wq"]["w"] = dst["blocks"][0]["attn"]["wq"]["w"].bfloat16()
    dst_state = opt_mod.adamw_init(lm.trainable(dst))
    ptrs = [t.data_ptr() for t in lm.trainable(dst) + dst_state["m"]]
    alias = dst["embed"]["table"][:4]  # a view held elsewhere
    step, _, _, meta = ckpt.load_checkpoint(str(tmp_path), dst, dst_state)
    assert step == 9 and meta["data_state"] == {"step": 9, "seed": 0}
    assert [t.data_ptr() for t in lm.trainable(dst) + dst_state["m"]] == ptrs
    for a, b in zip(lm.trainable(dst) + dst_state["m"] + dst_state["v"],
                    lm.trainable(src) + state["m"] + state["v"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(alias, src["embed"]["table"][:4]) and dst_state["count"] == 17
    with pytest.raises(ValueError, match="shape mismatch"):
        bad = init_train_params(cfg, seed=0, device="cpu")
        bad["final_norm"]["scale"] = torch.zeros(3)
        ckpt.load_checkpoint(str(tmp_path), bad)


# ---------------------------------------------------------------------------
# The port's Trainer: every recovery path
# ---------------------------------------------------------------------------


def _make_trainer(workdir, *, batch=2, seq=16, lr=1e-3, total=40, seed=0, params_seed=0,
                  **kw):
    cfg = get_config(ARCH, reduced=True)
    opt = opt_mod.OptimizerConfig(peak_lr=lr, warmup_steps=2, total_steps=total)
    data = SyntheticLMData(cfg.vocab, batch, seq, seed=seed)
    params = init_train_params(cfg, seed=params_seed, device="cpu")
    return Trainer(cfg, opt, data, params, workdir=workdir, log_every=1000, **kw)


_LOOSE = AnomalyConfig(warmup=3, z_threshold=6.0)


def _names(d):
    return ckpt.list_checkpoint_names(os.path.join(d, "checkpoints"))


def test_no_workdir_writes_nothing_and_keeps_the_guard_off(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    inj = FaultInjector([FaultSpec("loss_spike", after=4)])
    tr = _make_trainer(None, anomaly=_LOOSE, faults=inj, ckpt_every=2)
    hist = tr.run(6)
    assert [r["step"] for r in hist] == list(range(1, 7)) and os.listdir(tmp_path) == []
    assert tr.counters_snapshot()["rollbacks"] == 0 and hist[4]["loss"] > 64 * hist[3]["loss"] / 2


def test_loss_spike_rolls_back_in_place_and_continues(tmp_path):
    inj = FaultInjector([FaultSpec("loss_spike", after=8)])
    rec = TraceRecorder()
    tr = _make_trainer(str(tmp_path), ckpt_every=5, anomaly=_LOOSE, faults=inj, trace=rec)
    leaves = lm.trainable(tr.params)
    ptrs = [t.data_ptr() for t in leaves]
    hist = tr.run(15)
    snap = tr.counters_snapshot()
    assert snap["rollbacks"] == 1 and snap["anomaly_halts"] == 0
    assert [r["step"] for r in hist] == list(range(1, 16))
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert [t.data_ptr() for t in lm.trainable(tr.params)] == ptrs  # restored in place
    (rb,) = [e for e in rec.events if e["name"] == "rollback"]
    assert rb["args"] == {"at": 8, "restored": 5}
    # Not rewound: 9 batches up to the spike, then 10 for steps 6..15.
    assert tr.dataset.state()["step"] == 19


def test_persistent_spike_exhausts_rollbacks_and_halts(tmp_path):
    inj = FaultInjector([FaultSpec("loss_spike", after=6, times=-1)])
    cfg = AnomalyConfig(warmup=3, z_threshold=6.0, max_rollbacks=2)
    tr = _make_trainer(str(tmp_path), ckpt_every=5, anomaly=cfg, faults=inj)
    with pytest.raises(AnomalyHalt):
        tr.run(15)
    snap = tr.counters_snapshot()
    assert snap["rollbacks"] == 2 and snap["anomaly_halts"] == 1
    assert any(n.endswith("-anomaly-halt") for n in _names(str(tmp_path)))
    assert snap["emergency_saves"] == 0


def test_torn_checkpoint_resume_falls_back(tmp_path):
    inj = FaultInjector([FaultSpec("ckpt_torn_write", uid=8)])
    tr = _make_trainer(str(tmp_path), ckpt_every=4, faults=inj)
    while tr.step < 8:
        tr.step_once()
    ckpt_dir = os.path.join(str(tmp_path), "checkpoints")
    assert ckpt.list_checkpoints(ckpt_dir) == [0, 4, 8]
    assert not ckpt.is_verified(os.path.join(ckpt_dir, "step_00000008"))
    tr2 = _make_trainer(str(tmp_path), ckpt_every=4, params_seed=5)
    assert tr2.step == 4 and tr2.counters_snapshot()["torn_ckpt_fallbacks"] == 1
    assert tr2.dataset.state() == {"step": 4, "seed": 0}
    for a, b in zip(lm.trainable(tr2.params), lm.trainable(tr.params)):
        assert a.shape == b.shape


def test_nan_grad_skipped_and_counted(tmp_path):
    inj = FaultInjector([FaultSpec("nan_grad", after=3)])
    tr = _make_trainer(str(tmp_path), ckpt_every=100, anomaly=_LOOSE, faults=inj)
    before = None
    hist = []
    for i in range(6):
        if i == 3:
            before = [t.clone() for t in lm.trainable(tr.params)]
        hist.append(tr.step_once())
        if i == 3:  # the poisoned step left params untouched
            assert all(torch.equal(a, b) for a, b in zip(lm.trainable(tr.params), before))
    snap = tr.counters_snapshot()
    assert snap["nan_skips"] == 1 and snap["rollbacks"] == 0
    assert not np.isfinite(hist[3]["loss"])
    assert all(np.isfinite(hist[i]["loss"]) for i in (2, 4, 5))


def test_nan_policy_halt_saves_tagged_checkpoint(tmp_path):
    inj = FaultInjector([FaultSpec("nan_grad", after=2)])
    tr = _make_trainer(str(tmp_path), ckpt_every=100, nan_policy="halt", faults=inj)
    with pytest.raises(FloatingPointError):
        tr.run(6)
    assert "step_00000002-nan-halt" in _names(str(tmp_path))
    assert tr.counters_snapshot()["nan_skips"] == 1


class _CrashingData:
    """Raises once the wrapped stream has yielded ``crash_after`` batches."""

    def __init__(self, inner, crash_after):
        self.inner = inner
        self.crash_after = crash_after
        self._served = 0

    def next_batch(self):
        if self._served >= self.crash_after:
            raise RuntimeError("data reader died")
        self._served += 1
        return self.inner.next_batch()

    def state(self):
        return self.inner.state()

    def restore(self, state):
        self.inner.restore(state)


def test_emergency_save_is_tagged_and_failures_are_logged(tmp_path, capsys, monkeypatch):
    tr = _make_trainer(str(tmp_path), ckpt_every=3)
    tr.dataset = _CrashingData(tr.dataset, crash_after=6)
    with pytest.raises(RuntimeError, match="data reader died"):
        tr.run(10)
    snap = tr.counters_snapshot()
    assert snap["emergency_saves"] == 1 and snap["emergency_save_failures"] == 0
    names = _names(str(tmp_path))
    assert "step_00000006" in names and "step_00000006-emergency" in names

    def _boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save_checkpoint", _boom)
    with pytest.raises(RuntimeError, match="data reader died"):
        tr.run(10)
    assert tr.counters_snapshot()["emergency_save_failures"] == 1
    assert "EMERGENCY SAVE FAILED" in capsys.readouterr().out


@pytest.mark.parametrize("ckpt_every,kill", [(5, 7), (100, 8)], ids=["periodic", "emergency"])
def test_resume_matches_uninterrupted_run(tmp_path, ckpt_every, kill):
    """Kill at step ``kill`` (abandoned after a periodic checkpoint at 5, or
    a crash that leaves an ``-emergency`` save) and resume with other
    weights: the resumed steps' losses equal an uninterrupted run's bit for
    bit."""
    straight = _make_trainer(str(tmp_path / "a"), ckpt_every=ckpt_every)
    for _ in range(12):
        straight.step_once()
    killed = _make_trainer(str(tmp_path / "b"), ckpt_every=ckpt_every)
    if ckpt_every == 100:
        killed.dataset = _CrashingData(killed.dataset, crash_after=kill)
        with pytest.raises(RuntimeError):
            killed.run(12)
        assert "step_00000008-emergency" in _names(str(tmp_path / "b"))
    else:
        for _ in range(kill):
            killed.step_once()
    resumed = _make_trainer(str(tmp_path / "b"), ckpt_every=ckpt_every, params_seed=3)
    start = 5 if ckpt_every == 5 else kill
    assert resumed.step == start
    while resumed.step < 12:
        resumed.step_once()
    want = [(r["step"], r["loss"], r["grad_norm"]) for r in straight.history[start:]]
    assert [(r["step"], r["loss"], r["grad_norm"]) for r in resumed.history] == want
    for a, b in zip(lm.trainable(resumed.params), lm.trainable(straight.params)):
        assert torch.equal(a, b)


def test_data_shard_corrupt_caught_by_anomaly_guard(tmp_path):
    """Scrambled labels push the loss back toward log(vocab); after warmup
    the excursion flags and the rollback trains past the window."""
    inj = FaultInjector([FaultSpec("data_shard_corrupt", after=39)])
    cfg = AnomalyConfig(warmup=10, z_threshold=3.0, min_rel_increase=0.06, max_rollbacks=3)
    tr = _make_trainer(str(tmp_path), batch=4, seq=32, lr=3e-3, total=60, ckpt_every=10,
                       anomaly=cfg, faults=inj)
    hist = tr.run(45)
    snap = tr.counters_snapshot()
    assert snap["data_corrupt_batches"] == 1
    assert snap["rollbacks"] == 1 and snap["anomaly_halts"] == 0
    assert [r["step"] for r in hist] == list(range(1, 46))
    assert hist[-1]["loss"] < 6.0


def test_train_registry_over_trainer(tmp_path):
    inj = FaultInjector([FaultSpec("nan_grad", after=1)])
    tr = _make_trainer(str(tmp_path), ckpt_every=100, faults=inj)
    tr.run(3)
    reg = train_registry(tr)
    names = [n for n, _, _ in reg._bound_samples()]
    assert sorted(names) == sorted(f"train_{k}" for k in COUNTER_KEYS)
    snap = reg.snapshot()
    for k, v in tr.counters_snapshot().items():
        assert snap["counters"][f"train_{k}"] == float(v)
    assert snap["counters"]["train_nan_skips"] == 1.0 and snap["gauges"]["train_step"] == 3
    assert snap["histograms"]["train_step_time_s"]["count"] == 3


# ---------------------------------------------------------------------------
# The port's Trainer beside the reference's
# ---------------------------------------------------------------------------


class StepClock:
    """Advances by one on every read, so each clock read shows in the trace."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        t, self.t = self.t, self.t + 1.0
        return t


@pytest.fixture(scope="module")
def ref_weights():
    rcfg = ref_get_config(ARCH, reduced=True)
    rparams = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    dcfg = rcfg.attention.distr
    proj = np.array(ref_lsh.make_projection(jax.random.PRNGKey(dcfg.proj_seed), dcfg.block_q))
    return jax.tree_util.tree_map(np.asarray, rparams), proj


def _pair_trainers(ref_weights, workdir, specs, **kw):
    """A reference Trainer and a port Trainer on the same weights (the
    reference's ``init_params(PRNGKey(0))``), data seed, fault specs and a
    step clock each, in ``workdir/ref`` and ``workdir/port``."""
    rparams, proj = ref_weights
    out = {}
    for pkg in ("ref", "port"):
        clock = StepClock()
        ref = pkg == "ref"
        cfg = (ref_get_config if ref else get_config)(ARCH, reduced=True)
        cfg = cfg.replace(attention=cfg.attention.with_impl("reference"))
        opt = (RefOptimizerConfig if ref else opt_mod.OptimizerConfig)(
            peak_lr=1e-3, warmup_steps=2, total_steps=40)
        data = (RefSyntheticLMData if ref else SyntheticLMData)(cfg.vocab, 2, 16, seed=0)
        inj = (ref_faults if ref else faults).FaultInjector(
            [(ref_faults if ref else faults).FaultSpec(**s) for s in specs])
        rec = (RefTraceRecorder if ref else TraceRecorder)(clock=clock)
        akw = {k: (ref_anomaly.AnomalyConfig(**vars(v)) if ref and k == "anomaly" else v)
               for k, v in kw.items()}
        common = dict(workdir=str(workdir / pkg), log_every=1000, faults=inj, clock=clock,
                      trace=rec, **akw)
        if ref:
            out[pkg] = ref_trainer.Trainer(cfg, opt, data, **common)
        else:
            params = from_jax_params(rparams, cfg, proj=proj, device="cpu",
                                     dtype=lm.param_dtype(cfg))
            out[pkg] = Trainer(cfg, opt, data, params, **common)
    return out["ref"], out["port"]


def _compare(ref, port):
    assert port.counters_snapshot() == ref.counters_snapshot()
    assert [r["step"] for r in port.history] == [r["step"] for r in ref.history]
    for a, b in zip(port.history, ref.history):
        assert (a["loss"] == pytest.approx(b["loss"], abs=1e-5, rel=1e-5)
                or not (np.isfinite(a["loss"]) or np.isfinite(b["loss"])))
        assert a["sec"] == b["sec"] and a["lr"] == pytest.approx(b["lr"], rel=1e-6)
    want = [(e["name"], e["ph"], e["t"], e["args"]) for e in ref.trace.events]
    got = [(e["name"], e["ph"], e["t"], e["args"]) for e in port.trace.events]
    assert got == want


def test_trainer_matches_reference_through_spike_nan_and_torn_resume(ref_weights, tmp_path):
    """A loss spike (one rollback), a NaN step (one skip) and a torn final
    save, then a second trainer in each workdir: equal counters, history
    steps, trace events (names, args and step-clock timestamps) and step
    times, and losses within 1e-5; both resume from step 6 past the torn
    save."""
    specs = [dict(point="loss_spike", after=5), dict(point="nan_grad", after=2),
             dict(point="ckpt_torn_write", uid=8)]
    ref, port = _pair_trainers(ref_weights, tmp_path, specs, ckpt_every=3, ckpt_keep=2,
                               anomaly=AnomalyConfig(warmup=3, z_threshold=6.0))
    ref.run(8)
    port.run(8)
    _compare(ref, port)
    snap = port.counters_snapshot()
    assert snap["rollbacks"] == 1 and snap["nan_skips"] == 1
    assert [r["step"] for r in port.history] == list(range(1, 9))
    assert _names(str(tmp_path / "port")) == _names(str(tmp_path / "ref"))
    ref2, port2 = _pair_trainers(ref_weights, tmp_path, [], ckpt_every=3, ckpt_keep=2)
    assert port2.step == ref2.step == 6
    assert port2.counters_snapshot() == ref2.counters_snapshot()
    assert port2.counters_snapshot()["torn_ckpt_fallbacks"] == 1
    assert port2.dataset.state() == ref2.dataset.state()
    ref2.step_once()
    port2.step_once()
    _compare(ref2, port2)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["halt", "corrupt", "emergency", "nan_halt"])
def test_trainer_matches_reference_slow(ref_weights, tmp_path, case):
    """The persistent-spike halt, a corrupt shard caught by the guard, an
    emergency save and the NaN halt, beside the reference's Trainer."""
    kw, specs, steps, raises = dict(ckpt_every=5), [], 12, None
    if case == "halt":
        specs = [dict(point="loss_spike", after=6, times=-1)]
        kw["anomaly"] = AnomalyConfig(warmup=3, z_threshold=6.0, max_rollbacks=2)
        raises = ref_anomaly.AnomalyHalt, AnomalyHalt  # (ref, port)
    elif case == "corrupt":
        specs = [dict(point="data_shard_corrupt", after=8)]
        kw["anomaly"] = AnomalyConfig(warmup=5, z_threshold=3.0, min_rel_increase=0.06)
    elif case == "nan_halt":
        specs = [dict(point="nan_grad", after=2)]
        kw["nan_policy"] = "halt"
        raises = FloatingPointError, FloatingPointError
    ref, port = _pair_trainers(ref_weights, tmp_path, specs, **kw)
    for tr, exc in zip((ref, port), raises or (None, None)):
        if case == "emergency":
            tr.dataset = _CrashingData(tr.dataset, crash_after=7)
            exc = RuntimeError
        if exc is None:
            tr.run(steps)
        else:
            with pytest.raises(exc):
                tr.run(steps)
    _compare(ref, port)
    assert _names(str(tmp_path / "port")) == _names(str(tmp_path / "ref"))
