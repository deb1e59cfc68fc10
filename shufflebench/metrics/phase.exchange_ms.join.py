"""phase.exchange_ms.join (ms, program span), in join.pkfk.128m
(HashJoin.step): device time a stage launched under the program's
``exchange.a2a`` span, innermost (the four all-to-alls' transpose
copies), in the stretch traced without frame annotations."""

from shufflebench.spans import phase_ms


def read(run):
    return phase_ms(run, "exchange.a2a")
