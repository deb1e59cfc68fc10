"""step.sync_ms.join (ms, program span), in join.pkfk.128m
(HashJoin.step): host time a stage in the CUDA runtime calls named
*Synchronize* that start inside the program's ``hashjoin.step`` span, on
its thread."""

from shufflebench.spans import sync_ms


def read(run):
    return sync_ms(run, "hashjoin.step")
