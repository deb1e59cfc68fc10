"""shuffle_gbps.join (GB/s, host clock), in join.pkfk.128m (HashJoin.step):
input bytes of every completed stage (keys and payloads as the cell
carries them) over the window's seconds; an overflowed stage counts as
failed, not work."""

from shufflebench.readers import completed_gbps


def read(run):
    return completed_gbps(run)
