"""phase.exchange_ms.terasort (ms, program span), in sort.u32.spmd
(TeraSorter.step): device time a stage launched under the program's
``exchange.a2a`` span, innermost (the all-to-all's transpose copies), in
the stretch traced without frame annotations."""

from shufflebench.spans import phase_ms


def read(run):
    return phase_ms(run, "exchange.a2a")
