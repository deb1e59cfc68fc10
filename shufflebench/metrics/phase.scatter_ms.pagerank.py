"""phase.scatter_ms.pagerank (ms, program span), in pagerank.g500-s26
(PageRank.step): device time a stage launched under the program's
``pagerank.scatter`` span, innermost, in the stretch traced without
frame annotations (``pagerank_spans.py``)."""

from shufflebench.pagerank_spans import phase_ms


def read(run):
    return phase_ms(run, "pagerank.scatter")
