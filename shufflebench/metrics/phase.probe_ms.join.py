"""phase.probe_ms.join (ms, program span), in join.pkfk.128m
(HashJoin.step): device time a stage launched under the program's
``hashjoin.probe`` span, innermost (the binary search, its clamp, the
gathers, hit and joined), in the stretch traced without frame
annotations."""

from shufflebench.spans import phase_ms


def read(run):
    return phase_ms(run, "hashjoin.probe")
