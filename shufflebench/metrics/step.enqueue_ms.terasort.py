"""step.enqueue_ms.terasort (ms, host clock), in sort.u32.spmd
(TeraSorter.step): the step call to its return, before the sync: the
host's issue cost of one stage, mean over the window."""

from shufflebench.readers import mean_ms


def read(run):
    return mean_ms(s.enqueue_s for s in run.stages)
