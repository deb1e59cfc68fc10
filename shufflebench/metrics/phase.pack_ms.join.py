"""phase.pack_ms.join (ms, program span), in join.pkfk.128m
(HashJoin.step): device time a stage launched under the program's
``hashjoin.pack`` span, innermost (each shard's radix partition and both
pack_by_partition calls), in the stretch traced without frame
annotations."""

from shufflebench.spans import phase_ms


def read(run):
    return phase_ms(run, "hashjoin.pack")
