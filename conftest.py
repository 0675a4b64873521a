"""Repository-wide pytest settings: how the suite runs, not what it tests.

It leaves every test, its marks and tests/conftest.py as they are, and
adds three things:

- a time limit for each test (setup, call and teardown together): past
  ``TEST_TIME_LIMIT`` seconds the test fails with the limit's message and
  the stack it hung in, the processes it started are killed, and the run
  goes on with the next test;
- under ``--dist loadfile``, the files in ``SPLIT_BY_FUNCTION`` go to the
  workers one test function at a time instead of as one file, so that
  their interpret-mode kernel tests spread over the workers;
- the cases tests/conftest.py puts in its ``deep`` tier also carry
  ``slow``, so ``-m "not slow"`` leaves them out as ``-m "not deep"``
  does: one filter for the slow cases. ``-m slow`` runs them.

Imports no JAX: pytest loads it for every directory of the repository,
portbench/tests on the GPU machine, which has no JAX, among them.
"""

import faulthandler
import os
import signal
import sys

import pytest

# About three times the longest default-tier test measured at -n 6 on an
# 8-core CPU box: tests/test_compact_groups.py::
# test_encoder_compact_groups_end_to_end, 156-186 s.
TEST_TIME_LIMIT = 500
# After the limit, how long the stuck main thread has to take the signal
# before faulthandler dumps every thread and ends the process (a hang in
# C code never returns to the interpreter); xdist then reports the crash
# on the test and starts a new worker.
HARD_EXIT_GRACE = 60

SPLIT_BY_FUNCTION = ("tests/test_kernels.py", "tests/test_compact_groups.py")

_stderr = None


class TimeLimitExceeded(Exception):
    pass


def _children(pid):
    kids = []
    try:
        tasks = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return kids
    for tid in tasks:
        try:
            with open(f"/proc/{pid}/task/{tid}/children") as f:
                kids += [int(k) for k in f.read().split()]
        except OSError:
            pass
    return kids


def _descendants(pid):
    found, todo = [], _children(pid)
    while todo:
        kid = todo.pop()
        found.append(kid)
        todo += _children(kid)
    return found


def pytest_configure(config):
    global _stderr
    # faulthandler writes to a file descriptor: keep one that pytest's
    # output capture does not swap out.
    if _stderr is None:
        _stderr = os.fdopen(os.dup(sys.__stderr__.fileno()), "w")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    limit = TEST_TIME_LIMIT
    expired = []

    def expire(signum, frame):
        expired.append(signum)
        raise TimeLimitExceeded(
            f"{item.nodeid} ran past the per-test time limit of {limit} s "
            f"(conftest.py TEST_TIME_LIMIT)")

    before = set(_descendants(os.getpid()))
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(
        limit + HARD_EXIT_GRACE, exit=True, file=_stderr or sys.__stderr__)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)
        if expired:
            for pid in set(_descendants(os.getpid())) - before:
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass


def pytest_collection_modifyitems(items):
    # Runs after tests/conftest.py's hook (the deeper conftest is called
    # first) and before -m deselects.
    for item in items:
        if item.get_closest_marker("deep"):
            item.add_marker(pytest.mark.slow)


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getoption("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SplitFileScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            path, _, test = nodeid.partition("::")
            if path in SPLIT_BY_FUNCTION:
                return path + "::" + test.split("[", 1)[0]
            return path

    return SplitFileScheduling(config, log)
