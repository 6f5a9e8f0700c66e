"""The port's defaults against the reference's, name by name: both
launchers' argparse defaults, ``Trainer.__init__``'s and
``launch/train.py::run``'s.  Every difference is listed here with its
reason; any other fails."""
import argparse
import inspect

import pytest

torch = pytest.importorskip("torch")

# Kept on purpose: the reference's /tmp/repro_train is shared by every
# config; the port's default resolves per config under the temp directory
# (launch.train.default_workdir), and Trainer(workdir=None) trains without
# checkpoints for tests and the smoke run.
KEPT = {"workdir"}
# The reference's mesh flags and Trainer argument, ported with the data,
# model and context-parallel training slice.
NOT_YET_PORTED = {"model_parallel", "context_parallel", "mesh"}
# The port's own: entry points run on the card unless asked for the CPU;
# the serve launcher's prompt mix, profile and attention override.
PORT_ONLY_FLAGS = {"train": {"device"}, "serve": {"device", "prompt_lens", "profile", "impl"}}
# The port's Trainer takes the params it trains; the reference's draws
# them from ``seed``.
PORT_ONLY_TRAINER = {"params"}
REF_ONLY_TRAINER = {"seed"}


class _Parsed(Exception):
    pass


def _flag_defaults(main, *args) -> dict:
    """{dest: default} of the parser ``main`` builds, read where it parses."""
    seen = []

    def parse_args(self, *a, **kw):
        seen.append(self)
        raise _Parsed

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse_args
    try:
        with pytest.raises(_Parsed):
            main(*args)
    finally:
        argparse.ArgumentParser.parse_args = real
    return {a.dest: a.default for a in seen[0]._actions if a.dest != "help"}


def _launchers(kind):
    if kind == "train":
        import repro.launch.train as ref
        import repro_torch.launch.train as port
    else:
        import repro.launch.serve as ref
        import repro_torch.launch.serve as port
    return _flag_defaults(ref.main), _flag_defaults(port.main, [])


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_launcher_flag_defaults_match_the_reference(kind):
    ref, port = _launchers(kind)
    assert set(ref) - set(port) == (NOT_YET_PORTED & set(ref))
    assert set(port) - set(ref) == PORT_ONLY_FLAGS[kind]
    differ = {k for k in set(ref) & set(port) if ref[k] != port[k]}
    assert differ == (KEPT & differ)
    if kind == "train":
        assert port["steps"] == ref["steps"] == 100
        assert differ == {"workdir"}


def test_trainer_defaults_match_the_reference():
    from repro.train.trainer import Trainer as RefTrainer
    from repro_torch.train.trainer import Trainer

    def defaults(cls):
        return {k: p.default for k, p in inspect.signature(cls.__init__).parameters.items()}

    ref, port = defaults(RefTrainer), defaults(Trainer)
    assert set(ref) - set(port) == REF_ONLY_TRAINER | (NOT_YET_PORTED & set(ref))
    assert set(port) - set(ref) == PORT_ONLY_TRAINER
    assert {k for k in set(ref) & set(port) if ref[k] != port[k]} == KEPT
    assert port["log_every"] == ref["log_every"] == 10


def test_launch_train_run_defaults_match_the_reference_flags():
    """``run``'s keyword defaults are the reference launcher's flag defaults
    (and the port launcher's, the workdir aside)."""
    import repro_torch.launch.train as port

    ref_flags, port_flags = _launchers("train")
    run = {k: p.default for k, p in inspect.signature(port.run).parameters.items()
           if p.default is not inspect.Parameter.empty}
    # ``run`` takes the recorder itself; the launcher's --trace is its path.
    assert set(run) - set(port_flags) == {"trace"} - set(port_flags)
    for name, value in run.items():
        if name in KEPT or name == "trace":
            continue
        assert value == port_flags[name], name
        if name in ref_flags:
            assert value == ref_flags[name], name
