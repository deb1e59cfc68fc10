"""phase.exchange_ms.pagerank (ms, program span), in pagerank.g500-s26
(PageRank.step): device time a stage launched under the exchange
program's ``exchange.a2a`` span, innermost (the ten all-to-alls of
float32 contributions), in the stretch traced without frame
annotations."""

from shufflebench.spans import phase_ms


def read(run):
    return phase_ms(run, "exchange.a2a")
