"""step.syncs.terasort (count, program span), in sort.u32.spmd
(TeraSorter.step): the CUDA runtime calls named *Synchronize* a stage
that start inside the program's ``terasort.step`` span, on its
thread."""

from shufflebench.spans import sync_count


def read(run):
    return sync_count(run, "terasort.step")
