"""phase.split_ms.terasort (ms, program span), in sort.u32.spmd
(TeraSorter.step): device time a stage launched under the program's
``terasort.split`` span, innermost (the range splits and their copies
into the send slab), in the stretch traced without frame annotations."""

from shufflebench.spans import phase_ms


def read(run):
    return phase_ms(run, "terasort.split")
