"""stage_ms.p95.terasort (ms, CUDA events), in sort.u32.spmd
(TeraSorter.step): 95th percentile of every stage of the window, each
from its issue to its last device work."""

from shufflebench.readers import device_p95_ms


def read(run):
    return device_p95_ms(run)
