"""phase.build_sort_ms.join (ms, program span), in join.pkfk.128m
(HashJoin.step): device time a stage launched under the program's
``hashjoin.build_sort`` span, innermost (the build keys' mask, argsort
and two gathers), in the stretch traced without frame annotations."""

from shufflebench.spans import phase_ms


def read(run):
    return phase_ms(run, "hashjoin.build_sort")
