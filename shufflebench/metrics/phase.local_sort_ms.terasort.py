"""phase.local_sort_ms.terasort (ms, program span), in sort.u32.spmd
(TeraSorter.step): device time a stage launched under the program's
``terasort.local_sort`` span, innermost (the local sorts, device_sort of
each shard), in the stretch traced without frame annotations."""

from shufflebench.spans import phase_ms


def read(run):
    return phase_ms(run, "terasort.local_sort")
