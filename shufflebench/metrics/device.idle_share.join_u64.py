"""device.idle_share.join_u64 (fraction, device trace), in
join.pkfk.u64.256m (HashJoin.step at 8-byte rows): 1 - union of CUDA
activity / traced stretch."""

from shufflebench.readers import idle_share


def read(run):
    return idle_share(run)
