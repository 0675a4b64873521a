"""The per-test time limit of the repository's conftest.py: a test that runs
past it fails with the limit's message and the stack it hung in, the
processes it started are killed, and the run goes on to the next test.

Each case runs an inner pytest on a generated tree whose own conftest loads
the real one and lowers its limit, so a case takes a few seconds."""

import os
import subprocess
import sys
from pathlib import Path

REPO_CONFTEST = Path(__file__).resolve().parent.parent / "conftest.py"

INNER_CONFTEST = '''
import importlib.util

_spec = importlib.util.spec_from_file_location("repo_conftest", {path!r})
_repo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_repo)
_repo.TEST_TIME_LIMIT = 1
_repo.HARD_EXIT_GRACE = 1

pytest_configure = _repo.pytest_configure
pytest_runtest_protocol = _repo.pytest_runtest_protocol
pytest_collection_modifyitems = _repo.pytest_collection_modifyitems
pytest_xdist_make_scheduler = _repo.pytest_xdist_make_scheduler
'''


def inner_tree(root, files):
    """Write an inner test tree under ``root`` with the repository's hooks
    at a 1 s limit; ``files`` maps relative paths to their text."""
    (root / "pytest.ini").write_text(
        "[pytest]\nmarkers =\n    deep: deep tier\n    slow: slow tier\n")
    (root / "conftest.py").write_text(
        INNER_CONFTEST.format(path=str(REPO_CONFTEST)))
    for name, text in files.items():
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        (root / name).write_text(text)


def run_inner(root, *args):
    # no plugin loads unasked (``-p xdist`` for a run on workers)
    env = dict(os.environ, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider", *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=60)
    return res.returncode, res.stdout + res.stderr


HUNG_ON_A_CHILD = '''
import subprocess
import sys


def test_hangs(tmp_path):
    child = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"],
        stdout=subprocess.PIPE)
    with open({pidfile!r}, "w") as f:
        f.write(str(child.pid))
    child.communicate(timeout=300)


def test_after_the_hang():
    pass
'''


def test_time_limit_fails_the_hung_test_and_the_run_goes_on(tmp_path):
    pidfile = tmp_path / "child.pid"
    inner_tree(tmp_path, {
        "test_inner.py": HUNG_ON_A_CHILD.format(pidfile=str(pidfile))})
    rc, out = run_inner(tmp_path, "-q", "test_inner.py")
    assert rc == 1, out
    assert ("test_inner.py::test_hangs ran past the per-test time limit "
            "of 1 s") in out, out
    # the failure's traceback is the stack the test hung in
    assert ">       child.communicate(timeout=300)" in out, out
    assert "TimeLimitExceeded" in out, out
    assert "1 failed, 1 passed" in out, out
    # the child it waited on did not outlive it
    pid = int(pidfile.read_text())
    assert not os.path.exists(f"/proc/{pid}"), out


BLOCKS_THE_SIGNAL = '''
import signal
import time


def test_blocks_the_signal():
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(60)


def test_after_the_hang():
    pass
'''


def test_hang_the_signal_cannot_reach_ends_the_worker(tmp_path):
    # a hang that never returns to the interpreter: faulthandler dumps the
    # stacks and ends the worker, xdist fails the test on a new worker
    inner_tree(tmp_path, {"test_inner.py": BLOCKS_THE_SIGNAL})
    rc, out = run_inner(tmp_path, "-q", "-p", "xdist", "-n", "1",
                        "test_inner.py")
    assert rc == 1, out
    assert "Timeout (0:00:02)!" in out, out
    assert 'test_inner.py", line 8 in test_blocks_the_signal' in out, out
    assert "crashed while running 'test_inner.py::test_blocks_the_signal'" \
        in out, out
    assert "1 failed, 1 passed" in out, out
