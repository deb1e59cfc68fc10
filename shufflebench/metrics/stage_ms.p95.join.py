"""stage_ms.p95.join (ms, CUDA events), in join.pkfk.128m (HashJoin.step):
95th percentile of every stage of the window, each from its issue to its
last device work."""

from shufflebench.readers import device_p95_ms


def read(run):
    return device_p95_ms(run)
