"""step.syncs.pagerank (count, program span), in pagerank.g500-s26
(PageRank.step): the CUDA runtime calls named *Synchronize* a stage
that start inside the program's ``pagerank.step`` span, on its thread."""

from shufflebench.pagerank_spans import sync_count


def read(run):
    return sync_count(run)
