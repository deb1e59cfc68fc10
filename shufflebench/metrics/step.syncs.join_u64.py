"""step.syncs.join_u64 (count, program span), in join.pkfk.u64.256m
(HashJoin.step at 8-byte rows): the CUDA runtime calls named
*Synchronize* a stage that start inside the program's ``hashjoin.step``
span, on its thread."""

from shufflebench.spans import sync_count


def read(run):
    return sync_count(run, "hashjoin.step")
