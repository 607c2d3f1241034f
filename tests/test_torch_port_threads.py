"""Under pytest-xdist, each worker's share of the cores for torch's
intra-op threads.

torch starts one OpenMP thread per core in every process. Under ``-n 6``
six workers then run six times as many threads as there are cores, and
their OpenMP barriers spin against each other: on an 8-core host the
port's eight slowest test files took 380 s at ``-n 6 --dist loadfile``
against 561 s one after another, and 106 s with two torch threads a
worker. Every xdist worker imports every test module before it runs a
test, so this module sets the share for its whole worker: the threads
torch would start, divided among the workers and rounded up, so that no
core is left idle; the processes a worker's tests start inherit it
through ``OMP_NUM_THREADS``. A run without xdist keeps torch's default.
"""

import math
import os

import pytest

torch = pytest.importorskip("torch")


def worker_threads(default: int, workers: int) -> int:
    """torch threads for one of ``workers`` processes that share the
    ``default`` threads torch starts in one."""
    return max(1, math.ceil(default / max(1, workers)))


WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
DEFAULT_THREADS = torch.get_num_threads()
if WORKERS > 1:
    torch.set_num_threads(worker_threads(DEFAULT_THREADS, WORKERS))
    # and for the CLI processes the worker's tests start
    os.environ.setdefault("OMP_NUM_THREADS", str(torch.get_num_threads()))


@pytest.mark.parametrize("default,workers,want",
                         [(8, 1, 8), (8, 6, 2), (8, 8, 1), (8, 16, 1),
                          (32, 6, 6), (1, 6, 1)])
def test_worker_threads_divide_the_cores(default, workers, want):
    assert worker_threads(default, workers) == want


def test_this_worker_runs_its_share():
    want = (worker_threads(DEFAULT_THREADS, WORKERS) if WORKERS > 1
            else DEFAULT_THREADS)
    assert torch.get_num_threads() == want
