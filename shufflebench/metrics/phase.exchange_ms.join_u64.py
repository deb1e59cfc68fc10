"""phase.exchange_ms.join_u64 (ms, program span), in join.pkfk.u64.256m
(HashJoin.step at 8-byte rows): device time a stage launched under the
program's ``exchange.a2a`` span, innermost (the four all-to-alls'
transpose copies of int64 slabs), in the stretch traced without frame
annotations."""

from shufflebench.spans import phase_ms


def read(run):
    return phase_ms(run, "exchange.a2a")
