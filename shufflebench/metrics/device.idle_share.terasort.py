"""device.idle_share.terasort (fraction, device trace), in sort.u32.spmd
(TeraSorter.step): 1 - union of CUDA activity / traced stretch."""

from shufflebench.readers import idle_share


def read(run):
    return idle_share(run)
