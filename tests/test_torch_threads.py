"""One compute thread a pool in every test process.

The tier-1 run starts several pytest workers on the machine's cores, and
each would otherwise keep torch's OpenMP pool and numpy's OpenBLAS pool
at one thread a core, whose threads spin between parallel regions
against the other workers. Every xdist worker collects the whole suite,
so each imports this module and the limits below hold for the whole run,
the JAX package's tests in the same worker included: the pools loaded by
then are cut to one thread, and those loaded later read the variables
set here (on a subset of the port's and the JAX package's test files
with six workers on eight cores, one thread a pool cut the wall time to
a third). A run of single files that leaves this module out keeps the
default pools. A test that compares results across thread counts pins
its own (the multi-process tests run their children and twins on one
thread too). threadpoolctl (which scikit-learn brings) is optional: where
it is missing, torch's pool and the variables are still set.
"""

import os

import torch

try:
    import threadpoolctl
except ImportError:  # optional, as scikit-learn is
    threadpoolctl = None

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
torch.set_num_threads(1)
if threadpoolctl is not None:
    threadpoolctl.threadpool_limits(limits=1)


def test_one_thread_a_pool():
    assert torch.get_num_threads() == 1
    pools = [] if threadpoolctl is None else threadpoolctl.threadpool_info()
    assert all(pool["num_threads"] == 1 for pool in pools
               if pool["internal_api"] in ("openblas", "openmp"))
