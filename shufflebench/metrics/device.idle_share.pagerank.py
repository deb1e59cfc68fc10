"""device.idle_share.pagerank (fraction, device trace), in
pagerank.g500-s26 (PageRank.step): 1 - union of CUDA activity / traced
stretch."""

from shufflebench.readers import idle_share


def read(run):
    return idle_share(run)
