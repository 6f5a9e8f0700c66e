"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests see 1 CPU device; only
launch/dryrun.py forces 512 host devices (and only in its own process)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:  # the container has no hypothesis and pip installs are off-limits
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import importlib.util

    _spec = importlib.util.spec_from_file_location(
        "hypothesis",
        os.path.join(os.path.dirname(__file__), "_hypothesis_fallback.py"),
    )
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _mod.strategies

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")
    config.addinivalue_line(
        "markers", "timeout(seconds): per-test wall-clock limit"
    )


# -- per-test timeout ------------------------------------------------------
# The chaos suite (tests/test_chaos.py) must fail loudly, not hang CI, when
# a fault wedges the scheduler.  pytest-timeout is used when installed; the
# container image ships without it, so fall back to SIGALRM (main thread,
# POSIX) with the same opt-out env knob.

_HAVE_PYTEST_TIMEOUT = False
try:  # pragma: no cover - depends on the environment
    import pytest_timeout  # noqa: F401

    _HAVE_PYTEST_TIMEOUT = True
except ModuleNotFoundError:
    pass

_DEFAULT_TIMEOUT = float(os.environ.get("REPRO_TEST_TIMEOUT", "900"))


def _timeout_for(item) -> float:
    m = item.get_closest_marker("timeout")
    if m is not None and m.args:
        return float(m.args[0])
    return _DEFAULT_TIMEOUT


if not _HAVE_PYTEST_TIMEOUT and hasattr(__import__("signal"), "SIGALRM"):
    import signal

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_call(item):
        seconds = _timeout_for(item)
        if seconds <= 0:
            yield
            return

        def _alarm(signum, frame):
            raise TimeoutError(
                f"{item.nodeid} exceeded {seconds:.0f}s "
                "(REPRO_TEST_TIMEOUT / @pytest.mark.timeout)"
            )

        prev = signal.signal(signal.SIGALRM, _alarm)
        signal.setitimer(signal.ITIMER_REAL, seconds)
        try:
            yield
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, prev)


def pytest_collection_modifyitems(config, items):
    """Tier-1 (`pytest -x -q`) skips slow tests (multi-step engine decodes);
    an explicit marker expression (`pytest -m slow`) still runs them."""
    if config.getoption("-m"):
        return
    skip_slow = pytest.mark.skip(reason="slow: opt in with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
