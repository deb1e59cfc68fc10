"""sort.device_ms.join (ms, device trace), in join.pkfk.128m
(HashJoin.step): device time a stage launched from ops/sort.py (sorts,
splits, partitions, packs, searches, merges)."""

from shufflebench.readers import module_ms


def read(run):
    return module_ms(run, "ops/sort.py")
