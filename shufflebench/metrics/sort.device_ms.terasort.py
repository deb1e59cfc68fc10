"""sort.device_ms.terasort (ms, device trace), in sort.u32.spmd
(TeraSorter.step): device time a stage launched from ops/sort.py (sorts,
splits, partitions, packs, searches, merges)."""

from shufflebench.readers import module_ms


def read(run):
    return module_ms(run, "ops/sort.py")
