"""device.idle_share.join (fraction, device trace), in join.pkfk.128m
(HashJoin.step): 1 - union of CUDA activity / traced stretch."""

from shufflebench.readers import idle_share


def read(run):
    return idle_share(run)
