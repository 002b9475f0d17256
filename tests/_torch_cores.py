"""Size each pytest-xdist worker's torch thread pool to its share of the
cores.

Under ``pytest -n N`` every worker is a process whose torch intra-op pool
is as wide as the machine, so N workers oversubscribe the cores N times
over and their spinning pools slow every port test.  ``share_cores``
gives each worker ``ceil(cores / N)`` threads; without xdist it does
nothing.  Each port test module calls it on import (xdist workers import
every collected module before running any test)."""
import os


def share_cores(torch) -> None:
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        cores = os.cpu_count() or 1
        torch.set_num_threads(max(1, -(-cores // int(workers))))
