"""phase.build_sort_ms.join_u64 (ms, program span), in join.pkfk.u64.256m
(HashJoin.step at 8-byte rows): device time a stage launched under the
program's ``hashjoin.build_sort`` span, innermost (the build keys' mask,
the 64-bit argsort and two gathers), in the stretch traced without
frame annotations."""

from shufflebench.spans import phase_ms


def read(run):
    return phase_ms(run, "hashjoin.build_sort")
