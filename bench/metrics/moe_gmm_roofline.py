"""The expert matmul kernels' share of their roofline over the window's
launches, in %: see ``bench.harness.counts``.  The reader of every
``moe_gmm_roofline.<cell kind>`` metric."""
from bench.harness.counts import moe_roofline


def read(rec):
    return moe_roofline(rec)
