"""phase.merge_ms.terasort (ms, program span), in sort.u32.spmd
(TeraSorter.step): device time a stage launched under the program's
``terasort.merge`` span, innermost (the merges of the received slabs and
their copies out), in the stretch traced without frame annotations."""

from shufflebench.spans import phase_ms


def read(run):
    return phase_ms(run, "terasort.merge")
