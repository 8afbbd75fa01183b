"""Limits of the test session: each pytest worker gets its share of the
CPU's cores, and every test phase a time limit.

pytest loads this file (the repository root is its rootdir) before
``tests/conftest.py`` and before any test module, so the thread caps
below are in the environment before the session imports torch, and
every subprocess a test starts inherits them.
"""

import contextlib
import faulthandler
import os
import signal

import pytest

# The workers of `pytest -n` share the host's cores: torch's default
# intra-op pool (one thread per core in every worker) oversubscribes
# them, and a parallel region waits for its slowest thread, so one
# pool per worker sized to its share of the cores.  XLA's threads are
# left alone: capping them did not speed the suite up.
WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = max(1, os.cpu_count() // WORKERS)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(THREADS)

import torch

torch.set_num_threads(THREADS)

# GNU OpenMP is not fork-safe: a child forked after its parent ran a
# parallel region on more than one thread waits for ever on the
# parent's pool, which the child does not have (the forked workers of a
# multiprocessing.Pool, as the JAX DataProvider makes).  One thread in
# a forked child never touches that pool.
os.register_at_fork(after_in_child=lambda: torch.set_num_threads(1))

# Each phase (setup, call, teardown) of a test gets this many seconds,
# over 3x the slowest test of the suite under `-n 6` (~205 s), so that
# a hang fails one test by its name and the run goes on.  The alarm
# cannot interrupt a hang in native code: if the phase has not ended a
# while after it, every thread's stack is written to the session's own
# stderr, which pytest does not capture.  (Not at the alarm itself:
# dumping the stacks while its exception unwinds them can crash the
# worker.  Nor ending the worker: under `--dist loadfile` pytest-xdist
# runs the crashed test again.)
TEST_TIME_LIMIT_S = 660
STACK_DUMP_AFTER_S = 60
_stack_dump = 2


def pytest_configure(config):
    """Keep a descriptor of stderr as it is outside pytest's capture."""
    global _stack_dump
    _stack_dump = os.dup(2)


@contextlib.contextmanager
def time_limit(name):
    """Fail ``name`` if the block runs past ``TEST_TIME_LIMIT_S``; an
    enclosing limit is re-armed with what it had left."""
    limit = TEST_TIME_LIMIT_S

    def expire(signum, frame):
        pytest.fail("%s ran past the %d s limit of a test phase"
                    % (name, limit))

    def arm(seconds):
        faulthandler.dump_traceback_later(seconds + STACK_DUMP_AFTER_S,
                                          file=_stack_dump)
        return signal.alarm(seconds)

    previous = signal.signal(signal.SIGALRM, expire)
    outer_left = arm(limit)
    try:
        yield
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)
        if outer_left:
            arm(outer_left)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with time_limit(item.nodeid):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with time_limit(item.nodeid):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with time_limit(item.nodeid):
        return (yield)
