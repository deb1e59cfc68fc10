"""A run driven past the look for a card, on the CPU, with the timed path
broken underneath: each fault the cell can have makes ``correct``
false. Faults: a step that returns its state unchanged; half of the
batch left out; the exchange between shards left out; an answer
altered where it is produced."""

import time

import pytest
import torch

from shufflebench import run


def _run(cell, cpu):
    return run.run_cell(cell, 11, 0.05, False, cpu, time.perf_counter())


# ---- sort.u32.spmd: TeraSorter.step
def _wrap_step(monkeypatch, change):
    from sparkrdma_tpu_torch.models.terasort import TeraSorter

    real = TeraSorter._build_step

    def build(self, n_local, capacity, adaptive):
        fn = real(self, n_local, capacity, adaptive)
        return lambda keys, edges=None: change(self, keys, *fn(keys))

    monkeypatch.setattr(TeraSorter, "_build_step", build)


def _sort_unchanged(self, keys, merged, totals, ovf):
    e = self.num_shards
    n = keys.numel() // e
    return keys.clone(), torch.full((e,), n, dtype=torch.int32), ovf


def _sort_half(self, keys, merged, totals, ovf):
    totals = totals.clone()
    totals[self.num_shards // 2:] = 0
    return merged, totals, ovf


def _sort_altered(self, keys, merged, totals, ovf):
    m = merged.view(torch.int32).clone()
    m[0] ^= 1
    return m.view(torch.uint32), totals, ovf


def _no_exchange(monkeypatch):
    from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram

    monkeypatch.setattr(ExchangeProgram, "program_for",
                        lambda self, rows, block, dtype: lambda send, counts: (send, counts))


@pytest.mark.parametrize("fault", ["unchanged", "half", "no_exchange", "altered"])
def test_sort_step_faults(fault, monkeypatch, tiny_cell, cpu):
    cell = tiny_cell("sort.u32.spmd")
    if fault == "no_exchange":
        _no_exchange(monkeypatch)
    else:
        _wrap_step(monkeypatch, {"unchanged": _sort_unchanged, "half": _sort_half,
                                 "altered": _sort_altered}[fault])
    res = _run(cell, cpu)
    assert not res["correct"], res["numbers"]


# ---- join.pkfk.128m: HashJoin.step
def _wrap_join(monkeypatch, change):
    from sparkrdma_tpu_torch.models.hashjoin import HashJoin

    real = HashJoin._build

    def build(self, nb, npl, cap_b, cap_p):
        fn = real(self, nb, npl, cap_b, cap_p)
        return lambda bk, bv, pk, pv: change(self, (bk, bv, pk, pv), *fn(bk, bv, pk, pv))

    monkeypatch.setattr(HashJoin, "_build", build)


def _join_unchanged(self, args, pk2, pv2, joined, pcnt, ovf):
    # the output slabs as they were before the step: nothing sent, nothing joined
    return (torch.zeros_like(pk2.view(torch.int32)).view(torch.uint32),
            torch.zeros_like(pv2), torch.zeros_like(joined), torch.zeros_like(pcnt), ovf)


def _join_half(self, args, pk2, pv2, joined, pcnt, ovf):
    pcnt = pcnt.clone()
    pcnt[:, self.num_shards // 2:] = 0
    return pk2, pv2, joined, pcnt, ovf


def _join_altered(self, args, pk2, pv2, joined, pcnt, ovf):
    j = joined.clone()
    j[0, 0, 0] += 1
    return pk2, pv2, j, pcnt, ovf


@pytest.mark.parametrize("fault", ["unchanged", "half", "no_exchange", "altered"])
def test_join_step_faults(fault, monkeypatch, tiny_cell, cpu):
    cell = tiny_cell("join.pkfk.128m")
    if fault == "no_exchange":
        _no_exchange(monkeypatch)
    else:
        _wrap_join(monkeypatch, {"unchanged": _join_unchanged, "half": _join_half,
                                 "altered": _join_altered}[fault])
    res = _run(cell, cpu)
    assert not res["correct"], res["numbers"]
