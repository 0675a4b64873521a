"""How the repository's conftest.py schedules and filters the suite: under
``--dist loadfile`` the files of ``SPLIT_BY_FUNCTION`` go to the workers one
test function at a time, and the ``deep`` tier is left out by
``-m "not slow"``."""

from test_conftest_limit import inner_tree, run_inner

RECORDS_ITS_WORKER = '''
import os
import time

import pytest


def _record(name):
    time.sleep(0.5)
    with open(os.path.join({out!r}, name), "w") as f:
        f.write(os.environ["PYTEST_XDIST_WORKER"])


@pytest.mark.parametrize("n", [0, 1])
def test_first(n):
    _record("{prefix}first%d" % n)


def test_second():
    _record("{prefix}second")
'''


def test_loadfile_hands_out_a_split_file_by_function(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    inner_tree(tmp_path, {
        "tests/test_kernels.py": RECORDS_ITS_WORKER.format(
            out=str(out), prefix=""),
        "tests/test_other.py": RECORDS_ITS_WORKER.format(
            out=str(out), prefix="other_")})
    # three work units (two functions of the split file, the other file
    # whole) for three workers: each worker takes one
    rc, log = run_inner(tmp_path, "-q", "-p", "xdist", "-n", "3",
                        "--dist", "loadfile", "tests")
    assert rc == 0, log
    ran_on = {p.name: p.read_text() for p in out.iterdir()}
    # a function's cases stay together; the split file's functions do not;
    # another file stays whole
    assert ran_on["first0"] == ran_on["first1"], ran_on
    assert ran_on["first0"] != ran_on["second"], ran_on
    assert (ran_on["other_first0"] == ran_on["other_first1"]
            == ran_on["other_second"]), ran_on


DEEP_BY_HOOK = '''
import pytest


def pytest_collection_modifyitems(items):
    for item in items:
        if item.name == "test_deep_by_hook":
            item.add_marker(pytest.mark.deep)
'''

TIERS = '''
import pytest


def test_default():
    pass


def test_deep_by_hook():
    pass


@pytest.mark.deep
def test_deep_by_mark():
    pass
'''


def test_deep_cases_are_slow(tmp_path):
    # the deep marks of a deeper conftest's hook count, as tests/conftest.py
    # adds its own
    inner_tree(tmp_path, {"tests/conftest.py": DEEP_BY_HOOK,
                          "tests/test_tiers.py": TIERS})
    rc, log = run_inner(tmp_path, "-q", "-m", "not slow", "tests")
    assert rc == 0, log
    assert "1 passed, 2 deselected" in log, log
    rc, log = run_inner(tmp_path, "-q", "-m", "slow", "tests")
    assert rc == 0, log
    assert "2 passed, 1 deselected" in log, log
