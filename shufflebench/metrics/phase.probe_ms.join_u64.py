"""phase.probe_ms.join_u64 (ms, program span), in join.pkfk.u64.256m
(HashJoin.step at 8-byte rows): device time a stage launched under the
program's ``hashjoin.probe`` span, innermost (the binary search over
64-bit keys, its clamp, the gathers, hit and joined), in the stretch
traced without frame annotations."""

from shufflebench.spans import phase_ms


def read(run):
    return phase_ms(run, "hashjoin.probe")
