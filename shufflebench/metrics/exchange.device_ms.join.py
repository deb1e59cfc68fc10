"""exchange.device_ms.join (ms, device trace), in join.pkfk.128m
(HashJoin.step): device time a stage launched from ops/exchange.py (the
all-to-all of ExchangeProgram)."""

from shufflebench.readers import module_ms


def read(run):
    return module_ms(run, "ops/exchange.py")
