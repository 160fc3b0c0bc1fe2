"""One CPU-thread rule for the port's tests: torch gets the process's cores
shared among the pytest-xdist workers, and a file run alone keeps them all.

Each worker's torch otherwise keeps one intra-op thread a core, so six
workers on eight cores run 48 threads, which on the small shapes of these
tests mostly spin-wait for each other: six port files took 260 s of wall
time under `-n 6` that way and 102 s with one thread a worker.

Every `test_torch_*.py` takes the fixture by importing it:

    from torch_threads import torch_threads  # noqa: F401
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """For the module's lifetime: max(1, cores // workers) intra-op threads
    for torch, and the same OMP_NUM_THREADS / MKL_NUM_THREADS for the
    interpreters a test starts. All three are restored after it, so other
    files in the worker run as they would without it."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, cores // workers)
    before = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", str(n))
        mp.setenv("MKL_NUM_THREADS", str(n))
        torch.set_num_threads(n)
        yield n
        torch.set_num_threads(before)
