"""A partitioned left-outer equi-join with unique build keys, at 8-byte
rows: uint64 keys and int64 payloads, in integer arithmetic only.

The probe side is split over ``E`` shards as the deployment holds it:
``ceil(P / E)`` rows a shard, the last shard padded with the key
0xFFFF_FFFF_FFFF_FFFF and the value ``miss_value``. Each shard sends
each row to shard ``key >> (64 - log2 E)``, rows in their input order;
each row joins the build value of its key, or ``miss_value``. The keys
are handled as their int64 bit patterns; unsigned order is int64 order
of the pattern XOR 2^63.

Judged: ``pk2`` (uint64), ``pv2``, ``joined`` (int64) ``[E, E, cap]``
(destination, source, slot) and ``pcnt`` ``[E, E]``. Numbers:

- ``count_mismatch``: over every completed stage, the sum of
  ``|pcnt - reference|``;
- ``row_mismatch``: in the sampled stage, the valid slots whose key,
  value or joined value differ from the reference, plus the count
  differences.

The control (:func:`control`) is this reference a width down: it joins
each row on a 32-bit fingerprint of its key, the XOR of the key's two
halves, as a hash table that compared hash codes and not keys would.
The cell's 2^24 build keys hold 31,238 pairs that share a fingerprint,
and the probes of the later key of each pair join the earlier one's
payload. (A 32-bit cut of the keys would not do: the keys are the
multiples ``i * 0x9E3779B97F4A7C15`` of ``i <= 2^24``, whose top 32
bits, as their low 32 bits, are all distinct.)
"""

from __future__ import annotations

import math
from typing import Dict

import torch

SIGN = -(1 << 63)  # the int64 bit pattern of 2^63
PADDING = -1  # 0xFFFF_FFFF_FFFF_FFFF as an int64
BLOCK = 1 << 24  # probe keys a search: the lookup's temporaries stay small


def padded_probe(inputs: Dict, shards: int, miss: int):
    """``(keys int64 bits, values int64, rows a shard)`` of the probe side
    laid over ``shards``."""
    k = inputs["probe_keys"].view(torch.int64)
    v = inputs["probe_vals"]
    n_local = math.ceil(k.numel() / shards)
    pad = shards * n_local - k.numel()
    k = torch.cat([k, torch.full((pad,), PADDING, dtype=torch.int64, device=k.device)])
    v = torch.cat([v, torch.full((pad,), miss, dtype=torch.int64, device=v.device)])
    return k, v, n_local


def destination(k: torch.Tensor, shards: int) -> torch.Tensor:
    """Shard ``key >> (64 - log2 E)`` of each key (int64 bit patterns): an
    arithmetic shift, the copies of the sign bit masked off."""
    lg = shards.bit_length() - 1
    return (k >> (64 - lg)) & (shards - 1) if lg else torch.zeros_like(k)


def fingerprint(k: torch.Tensor, bits: int) -> torch.Tensor:
    """Each key (int64 bit patterns) as an int64 to compare and order:
    at 64 bits the key itself in unsigned order (XOR 2^63); at fewer
    (a divisor of 64) the XOR of its ``64 / bits`` pieces of ``bits``
    bits."""
    if bits == 64:
        return k ^ SIGN
    mask = (1 << bits) - 1
    out = k & mask
    for shift in range(bits, 64, bits):
        out ^= (k >> shift) & mask
    return out


class Lookup:
    """Build key -> build value, by a sorted copy of the build keys,
    searched ``BLOCK`` probes at a time; keys compare by their ``bits``-bit
    :func:`fingerprint` (64: exact)."""

    def __init__(self, inputs: Dict, miss: int, bits: int = 64):
        self.bits = bits
        keys = fingerprint(inputs["build_keys"].view(torch.int64), bits)
        self.keys, order = torch.sort(keys, stable=True)
        self.vals = inputs["build_vals"][order]
        self.miss = miss

    def __call__(self, k: torch.Tensor) -> torch.Tensor:
        out = []
        for block in k.split(BLOCK):
            q = fingerprint(block, self.bits)
            pos = torch.searchsorted(self.keys, q).clamp_(max=self.keys.numel() - 1)
            out.append(torch.where(self.keys[pos] == q, self.vals[pos],
                                   torch.full_like(q, self.miss)))
        return torch.cat(out) if out else k.clone()


def expected(inputs: Dict, config: Dict, lookup: Lookup):
    """Per source shard ``s``: ``(s, [E] counts, [(keys, values, joined)
    per destination])``, one shard at a time."""
    e = int(config["shards"])
    miss = int(config["miss_value"])
    k, v, n_local = padded_probe(inputs, e, miss)
    for s in range(e):
        ks, vs = k[s * n_local:(s + 1) * n_local], v[s * n_local:(s + 1) * n_local]
        dest = destination(ks, e)
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
    pk2 = judged["pk2"].view(torch.int64)
    pv2, joined = judged["pv2"], judged["joined"]
    pcnt = judged["pcnt"].cpu().tolist()
    want = [[0] * e for _ in range(e)]
    rows_off = 0
    for s, counts, rows in expected(inputs, config, lookup):
        for d in range(e):
            want[d][s] = counts[d]
            c = int(pcnt[d][s])
            ek, ev, ej = rows[d]
            m = min(c, ek.numel())
            gk, gv, gj = pk2[d, s, :m], pv2[d, s, :m], joined[d, s, :m]
            rows_off += int(((gk != ek[:m]) | (gv != ev[:m]) | (gj != ej[:m])).sum())
            rows_off += abs(c - ek.numel())
    total = bad = 0
    for counts in stage_counts:
        off = sum(abs(int(counts[d][s]) - want[d][s]) for d in range(e) for s in range(e))
        total += off
        bad += off > 0
    numbers = {"count_mismatch": total, "row_mismatch": rows_off}
    return numbers, bad + (rows_off > 0 and bad == 0)


def control(inputs: Dict, config: Dict, bits: int = 32):
    """The reference a width down: rows partitioned exactly, each joined
    on the ``bits``-bit :func:`fingerprint` of its key. Returns
    ``(judged, counts)`` in the program's place."""
    e = int(config["shards"])
    lookup = Lookup(inputs, int(config["miss_value"]), bits=bits)
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
    judged = {"pk2": pk2.view(torch.uint64), "pv2": pv2, "joined": joined, "pcnt": pcnt}
    return judged, pcnt.tolist()
