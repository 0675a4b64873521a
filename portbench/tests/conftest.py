"""Shared fixtures of the benchmark's tests: the repository's root on the
path (the harness is the package ``portbench``); the benchmark as
``BENCHMARK.json`` states it; and a card for the tests marked ``gpu``,
looked for inside the fixture."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture(scope="session")
def bench():
    from portbench import harness
    return harness.Bench()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
