"""One CPU thread budget for each pytest-xdist worker.

Each worker process would otherwise start native thread pools (torch's
OpenMP, numpy's BLAS) as wide as the machine, so `-n 6` on 8 cores runs
about a hundred threads that spin against each other. In a worker this
gives each pool `cpu_count // worker_count` threads, and sets the
variables that the subprocesses tests start read. A run without xdist
is left as it is.
"""

import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    _n = max(1, (os.cpu_count() or 1) // int(_workers))
    for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, str(_n))

    import torch

    torch.set_num_threads(_n)
    # numpy's BLAS pool already exists: a pytest plugin (jaxtyping's)
    # imports numpy before any conftest, so the variables come too late
    # for it
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        pass
    else:
        threadpool_limits(_n, user_api="blas")
