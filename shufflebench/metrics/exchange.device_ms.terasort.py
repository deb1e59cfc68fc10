"""exchange.device_ms.terasort (ms, device trace), in sort.u32.spmd
(TeraSorter.step): device time a stage launched from ops/exchange.py
(the all-to-all of ExchangeProgram)."""

from shufflebench.readers import module_ms


def read(run):
    return module_ms(run, "ops/exchange.py")
