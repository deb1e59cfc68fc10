"""step.sync_ms.terasort (ms, program span), in sort.u32.spmd
(TeraSorter.step): host time a stage in the CUDA runtime calls named
*Synchronize* that start inside the program's ``terasort.step`` span, on
its thread."""

from shufflebench.spans import sync_ms


def read(run):
    return sync_ms(run, "terasort.step")
