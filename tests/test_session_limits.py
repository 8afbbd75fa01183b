"""The test session's own limits (the repository's root ``conftest.py``):
one torch thread pool per pytest worker, sized to its share of the cores
and inherited by subprocesses, one thread in forked children, and a time
limit on every test phase."""

import multiprocessing
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
ROOT_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"


@pytest.fixture(scope="module")
def limits(pytestconfig):
    """The root conftest module, as pytest loaded it."""
    module = pytestconfig.pluginmanager.get_plugin(str(ROOT_CONFTEST))
    assert module is not None, "pytest did not load %s" % ROOT_CONFTEST
    return module


def worker_share():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, os.cpu_count() // workers)


def alarm_left():
    return signal.getitimer(signal.ITIMER_REAL)[0]


def test_torch_threads_are_the_workers_share(limits):
    assert torch.get_num_threads() == worker_share() == limits.THREADS


@pytest.mark.parametrize("var", THREAD_VARS)
def test_thread_cap_is_in_the_environment(var):
    assert os.environ[var] == str(worker_share())


def test_subprocess_inherits_the_thread_cap():
    code = ("import os, torch; print(*[os.environ[v] for v in %r], "
            "torch.get_num_threads())" % (THREAD_VARS,))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert out == [str(worker_share())] * (len(THREAD_VARS) + 1)


def _child_sum(n):
    return torch.get_num_threads(), float(torch.ones(n).mul(2).sum())


def test_forked_child_of_a_multithreaded_worker_runs():
    # The JAX DataProvider forks a multiprocessing.Pool; after a
    # parallel region on 2 threads, a forked child's own parallel
    # region used to wait for ever on the parent's OpenMP pool.
    n = 1 << 22
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert float(torch.ones(n).mul(2).sum()) == 2.0 * n
        with multiprocessing.get_context("fork").Pool(1) as pool:
            result = pool.apply_async(_child_sum, (n,)).get(timeout=60)
        assert result == (1, 2.0 * n)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def alarm_at_setup():
    return alarm_left()


def test_alarm_is_armed_while_a_test_runs(limits, alarm_at_setup):
    assert 0 < alarm_at_setup <= limits.TEST_TIME_LIMIT_S
    assert 0 < alarm_left() <= limits.TEST_TIME_LIMIT_S
    assert signal.getsignal(signal.SIGALRM) not in (
        signal.SIG_DFL, signal.SIG_IGN, None)


def test_alarm_is_disarmed_when_its_phase_ends(limits):
    own_handler = signal.getsignal(signal.SIGALRM)
    own_left = signal.alarm(0)
    try:
        with limits.time_limit("inner"):
            assert 0 < alarm_left() <= limits.TEST_TIME_LIMIT_S
            assert signal.getsignal(signal.SIGALRM) is not own_handler
        assert alarm_left() == 0
        assert signal.getsignal(signal.SIGALRM) is own_handler
    finally:
        signal.alarm(own_left)


def test_nested_limit_rearms_the_outer_one(limits):
    own_handler = signal.getsignal(signal.SIGALRM)
    with limits.time_limit("inner"):
        assert signal.getsignal(signal.SIGALRM) is not own_handler
    assert 0 < alarm_left() <= limits.TEST_TIME_LIMIT_S
    assert signal.getsignal(signal.SIGALRM) is own_handler


def test_phase_past_the_limit_fails_by_its_name(limits, monkeypatch):
    monkeypatch.setattr(limits, "TEST_TIME_LIMIT_S", 1)
    own_left = signal.alarm(0)
    try:
        start = time.monotonic()
        with pytest.raises(pytest.fail.Exception,
                           match=r"tests/slow\.py::test_x ran past the 1 s"):
            with limits.time_limit("tests/slow.py::test_x"):
                time.sleep(30)
        assert time.monotonic() - start < 10
        assert alarm_left() == 0
    finally:
        signal.alarm(own_left)
