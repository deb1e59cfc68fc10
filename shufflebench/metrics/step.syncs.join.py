"""step.syncs.join (count, program span), in join.pkfk.128m
(HashJoin.step): the CUDA runtime calls named *Synchronize* a stage that
start inside the program's ``hashjoin.step`` span, on its thread."""

from shufflebench.spans import sync_count


def read(run):
    return sync_count(run, "hashjoin.step")
