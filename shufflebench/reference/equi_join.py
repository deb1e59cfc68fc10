"""A partitioned left-outer equi-join with unique build keys.

The probe side is split over ``E`` shards as the deployment holds it:
``ceil(P / E)`` rows a shard, the last shard padded with the key
0xFFFFFFFF and the value ``miss_value``. Each shard sends each row to
shard ``key >> (32 - log2 E)``, rows in their input order; each row
joins the build value of its key, or ``miss_value``.

Judged: ``pk2``, ``pv2``, ``joined`` ``[E, E, cap]`` (destination,
source, slot) and ``pcnt`` ``[E, E]``. Numbers:

- ``count_mismatch``: over every completed stage, the sum of
  ``|pcnt - reference|``;
- ``row_mismatch``: in the sampled stage, the valid slots whose key,
  value or joined value differ from the reference, plus the count
  differences.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

MASK = 0xFFFFFFFF


def u64(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32).to(torch.int64) & MASK


def padded_probe(inputs: Dict, shards: int, miss: int):
    """``(keys int64, values int64, rows a shard)`` of the probe side laid
    over ``shards``."""
    k = u64(inputs["probe_keys"])
    v = inputs["probe_vals"].to(torch.int64)
    n_local = math.ceil(k.numel() / shards)
    pad = shards * n_local - k.numel()
    k = torch.cat([k, torch.full((pad,), MASK, dtype=torch.int64, device=k.device)])
    v = torch.cat([v, torch.full((pad,), miss, dtype=torch.int64, device=v.device)])
    return k, v, n_local


class Lookup:
    """Build key -> build value, by a sorted copy of the build keys;
    ``bits`` keeps that many top bits of each key (32: exact)."""

    def __init__(self, inputs: Dict, miss: int, bits: int = 32):
        self.shift = 32 - bits
        keys = u64(inputs["build_keys"]) >> self.shift
        self.keys, order = torch.sort(keys, stable=True)
        self.vals = inputs["build_vals"].to(torch.int64)[order]
        self.miss = miss

    def __call__(self, k: torch.Tensor) -> torch.Tensor:
        k = k >> self.shift
        pos = torch.searchsorted(self.keys, k).clamp_(max=self.keys.numel() - 1)
        return torch.where(self.keys[pos] == k, self.vals[pos],
                           torch.full_like(k, self.miss))


def expected(inputs: Dict, config: Dict, lookup: Lookup):
    """Per source shard ``s``: ``(s, [E] counts, [(keys, values, joined)
    per destination])``, one shard at a time."""
    e = int(config["shards"])
    miss = int(config["miss_value"])
    k, v, n_local = padded_probe(inputs, e, miss)
    shift = 32 - (e.bit_length() - 1)
    for s in range(e):
        ks, vs = k[s * n_local:(s + 1) * n_local], v[s * n_local:(s + 1) * n_local]
        dest = ks >> shift
        order = torch.sort(dest, stable=True).indices
        counts = torch.bincount(dest, minlength=e).tolist()
        rows, at = [], 0
        for d in range(e):
            idx = order[at:at + counts[d]]
            at += counts[d]
            rows.append((ks[idx], vs[idx], lookup(ks[idx])))
        yield s, counts, rows


def compare(judged: Dict, stage_counts, inputs: Dict, config: Dict):
    e = int(config["shards"])
    lookup = Lookup(inputs, int(config["miss_value"]))
    pk2, pv2, joined = judged["pk2"], judged["pv2"], judged["joined"]
    pcnt = judged["pcnt"].cpu().tolist()
    want = [[0] * e for _ in range(e)]
    rows_off = 0
    for s, counts, rows in expected(inputs, config, lookup):
        for d in range(e):
            want[d][s] = counts[d]
            c = int(pcnt[d][s])
            ek, ev, ej = rows[d]
            m = min(c, ek.numel())
            gk = u64(pk2[d, s, :m].contiguous())
            gv = pv2[d, s, :m].to(torch.int64)
            gj = joined[d, s, :m].to(torch.int64)
            rows_off += int(((gk != ek[:m]) | (gv != ev[:m]) | (gj != ej[:m])).sum())
            rows_off += abs(c - ek.numel())
    total = bad = 0
    for counts in stage_counts:
        off = sum(abs(int(counts[d][s]) - want[d][s]) for d in range(e) for s in range(e))
        total += off
        bad += off > 0
    numbers = {"count_mismatch": total, "row_mismatch": rows_off}
    return numbers, bad + (rows_off > 0 and bad == 0)


def control(inputs: Dict, config: Dict):
    """The reference at the next width down: rows partitioned exactly,
    each joined on the top 16 bits of its key (a 16-bit key
    fingerprint). Returns ``(judged, counts)`` in the program's place."""
    e = int(config["shards"])
    lookup = Lookup(inputs, int(config["miss_value"]), bits=16)
    got = list(expected(inputs, config, lookup))
    cap = max(max(c) for _, c, _ in got)
    dev = inputs["probe_keys"].device
    pk2 = torch.zeros((e, e, cap), dtype=torch.int64, device=dev)
    pv2 = torch.zeros_like(pk2)
    joined = torch.zeros_like(pk2)
    pcnt = torch.zeros((e, e), dtype=torch.int32)
    for s, counts, rows in got:
        for d, (k, v, j) in enumerate(rows):
            pk2[d, s, :counts[d]], pv2[d, s, :counts[d]] = k, v
            joined[d, s, :counts[d]] = j
            pcnt[d, s] = counts[d]
    judged = {"pk2": (pk2 - ((pk2 >> 31) << 32)).to(torch.int32).view(torch.uint32),
              "pv2": pv2.to(torch.int32), "joined": joined.to(torch.int32),
              "pcnt": pcnt}
    return judged, pcnt.tolist()
