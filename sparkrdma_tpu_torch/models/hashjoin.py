"""Device-resident distributed hash join — the shuffle-heavy join workload.

The PyTorch counterpart of the JAX package's ``models/hashjoin.py``
(TPC-DS q64/q72's shuffle-heavy hash joins). Both sides radix-partition
on the key's top bits, every shard of a side in one ``radix_pack_pairs``
call (on CUDA one hand-written pack kernel, keys and payloads together),
and ride one all-to-all each (``ExchangeProgram`` over the shard
stack); the local join sorts the build side and searches it for the
probes.

Join shape: the build side has UNIQUE keys (the dimension-table case);
every probe row matches at most one build row, so the output is exactly
probe-sized. Probe rows with no match return ``miss_value`` (left-outer
semantics). The output rows are the JAX package's, in its order.

Two row widths, chosen by the dtypes handed to ``place`` / ``join``:
uint32 keys with int32 payloads (the JAX package's), and uint64 keys
with int64 payloads, carried at 64 bits all the way (the pack launches
``srt_radix_pack64``, the slabs ride the all-to-all as int64, the build
sort and the search order uint64). A wide step partitions on the top
log2 E bits of the 64-bit key and pads with 0xFFFF_FFFF_FFFF_FFFF.

A step opens spans (``obs/trace.py`` ``span``): ``hashjoin.step`` once
around ``_build``'s ``fn``, the whole step; directly in it
``hashjoin.pack`` once a side (``radix_pack_pairs``: every shard's keys
and payloads), ``hashjoin.build_sort`` once (the build keys' mask,
``device_argsort``, the two gathers), ``hashjoin.probe`` once
(``probe_sorted``, on CUDA one ``srt_sorted_probe`` or
``srt_sorted_probe64`` call: a key directory a shard and a search of one
bucket a probe slot), and the exchange's ``exchange.a2a`` four times;
both widths open the same spans. The probe's counters stay on the
device (``last_probe_stats``); ``join`` adds them to the registry's
``hashjoin.probes`` and ``hashjoin.probe_bucket_steps`` after each
step's overflow read.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.models.terasort import KEY_BITS, SENTINEL
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.obs.trace import span
from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram
from sparkrdma_tpu_torch.ops.sort import device_argsort, probe_sorted, radix_pack_pairs
from sparkrdma_tpu_torch.parallel.mesh import ShardMesh, mesh_or_one_shard
from sparkrdma_tpu_torch.utils.torch_compat import torch_dtype

_SENTINEL_BITS = -1  # the padding key (each width's maximum) as its signed bit pattern


class _Width(NamedTuple):
    bits: torch.dtype  # the signed dtype of the keys' bit pattern, and the payloads'
    key_bits: int  # the partition is the key's top log2 E bits below this
    pad: int  # the padding key: the key dtype's maximum
    np_key: type
    np_val: type


_WIDTHS = {torch.uint32: _Width(torch.int32, KEY_BITS, int(SENTINEL), np.uint32, np.int32),
           torch.uint64: _Width(torch.int64, 64, (1 << 64) - 1, np.uint64, np.int64)}


def _width_of(key_dtype: torch.dtype) -> _Width:
    if key_dtype not in _WIDTHS:
        raise ValueError(f"HashJoin joins uint32 or uint64 keys, not {key_dtype}")
    return _WIDTHS[key_dtype]


class HashJoin:
    """Distributed left-outer join over a mesh of E shards (E a power of
    two). ``mesh`` defaults to one shard on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for)."""

    def __init__(self, mesh: Optional[ShardMesh] = None,
                 capacity_factor: float = 2.0, miss_value: int = -1,
                 device=None):
        self.mesh = mesh_or_one_shard(mesh, device)
        self.device = self.mesh.device
        self.num_shards = self.mesh.num_shards
        if self.num_shards & (self.num_shards - 1):
            raise ValueError("HashJoin requires a power-of-two shard count")
        self.capacity_factor = capacity_factor
        self.miss_value = miss_value
        self._exchange = ExchangeProgram(self.mesh)
        self._cache = {}
        # the (cap_b, cap_p) of each step the last ``join`` ran, and its
        # walls: pad and upload, the capacity ladder's steps (ending in
        # the overflow readback), row assembly and readback
        self.last_capacities: List[Tuple[int, int]] = []
        self.last_walls: Dict[str, float] = {}
        # the last step's int64 [E, 2] probe counters on the device: each
        # shard's valid probes and bucket search steps (probe_sorted's
        # stats); the step never reads them
        self.last_probe_stats: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    def _build(self, nb_local: int, np_local: int, cap_b: int, cap_p: int):
        e = self.num_shards
        miss = self.miss_value

        def scatter(keys: torch.Tensor, vals: torch.Tensor, cap: int, width: _Width):
            # keys/vals: [E, n_local] shard stacks; every shard packs its
            # rows by destination in one call and the slabs ride one
            # all-to-all
            with span("hashjoin.pack"):
                kslab, vslab, counts, flags = radix_pack_pairs(
                    keys, vals, e, cap, width.key_bits, key_fill=width.pad, val_fill=miss)
            a2a = self._exchange.program_for(e, cap, width.bits)
            k2, c2 = a2a(kslab.view(width.bits).view(e * e, cap), counts.view(-1))
            del kslab
            v2, _ = a2a(vslab.view(e * e, cap), counts.view(-1))
            return k2.view(e, e, cap), v2.view(e, e, cap), c2.view(e, e), flags.any()

        def valid(cnt: torch.Tensor, cap: int) -> torch.Tensor:
            col = torch.arange(cap, dtype=torch.int32, device=cnt.device)
            return (col[None, None, :] < cnt[:, :, None]).view(e, -1)

        def fn(bk, bv, pk, pv):
            # bk/pk: [E * n_local] uint32 or uint64 stacks; bv/pv: int32 or
            # int64 payloads, the width the keys' dtype names
            with span("hashjoin.step"):
                key_dtype = bk.dtype
                width = _width_of(key_dtype)
                for x, n, dt in ((bk, nb_local, key_dtype), (bv, nb_local, width.bits),
                                 (pk, np_local, key_dtype), (pv, np_local, width.bits)):
                    if x.shape != (e * n,) or x.dtype != dt:
                        raise ValueError(f"step built for [{e * n}] {dt}, got "
                                         f"{list(x.shape)} {x.dtype}")
                bk2, bv2, bcnt, ovf_b = scatter(bk.view(e, -1), bv.view(e, -1), cap_b, width)
                pk2, pv2, pcnt, ovf_p = scatter(pk.view(e, -1), pv.view(e, -1), cap_p, width)
                # any shard overflowing aborts the round everywhere (the pmax)
                overflow = (ovf_b | ovf_p).to(torch.int32)

                # local join, every shard at once: sort the build side (the
                # padding masked to SENTINEL), binary-search the probes
                with span("hashjoin.build_sort"):
                    bkeys = torch.where(valid(bcnt, cap_b), bk2.view(e, -1),
                                        _SENTINEL_BITS).view(key_dtype)
                    order = device_argsort(bkeys)
                    bkeys_s = torch.gather(bkeys.view(width.bits), 1, order)
                    bvals_s = torch.gather(bv2.view(e, -1), 1, order)
                    del bkeys, order
                with span("hashjoin.probe"):
                    joined, self.last_probe_stats = probe_sorted(
                        bkeys_s.view(key_dtype), bvals_s, bcnt, pk2.view(key_dtype), pcnt, miss)
                # [E, E, cap_p] rows aligned with pk2/pv2: shard d's row s is
                # what shard s sent it, its first pcnt[d, s] slots valid
                return (pk2.view(key_dtype), pv2, joined.view(e, e, cap_p), pcnt,
                        overflow)

        return fn

    def step(self, nb_local: int, np_local: int, cap_b: int, cap_p: int) -> Callable:
        """The cached join step ``fn(bk, bv, pk, pv) -> (pk2, pv2, joined,
        pcnt, overflow)`` over ``[E * n_local]`` shard stacks on the
        mesh's device. It runs at the width of the stacks each call hands
        it: uint32 keys with int32 payloads and ``joined``, or uint64 keys
        with int64 ones."""
        key = (nb_local, np_local, cap_b, cap_p)
        fn = self._cache.get(key)
        if fn is None:
            fn = self._build(nb_local, np_local, cap_b, cap_p)
            self._cache[key] = fn
        return fn

    def _count_probes(self) -> None:
        """Add the last step's probe counters to the registry's
        ``hashjoin.probes`` and ``hashjoin.probe_bucket_steps``."""
        probes, steps = self.last_probe_stats.sum(0).tolist()
        reg = get_registry()
        reg.counter("hashjoin.probes").inc(probes)
        reg.counter("hashjoin.probe_bucket_steps").inc(steps)

    def _rows(self, pk2, pv2, joined, pcnt) -> torch.Tensor:
        """The ``[m, 3]`` int64 output rows on the device: every valid slot
        whose key is not the padding key (``shard_pad``'s), in (dest
        shard, source shard, slot) order — the JAX package's triple loop
        as one mask. A uint64 key is its int64 bit pattern."""
        cap = pk2.shape[-1]
        col = torch.arange(cap, dtype=torch.int32, device=pk2.device)
        keys = pk2.view(_width_of(pk2.dtype).bits)
        take = ((col < pcnt[..., None]) & (keys != _SENTINEL_BITS)).view(-1)
        at = take.nonzero().squeeze(1)
        del take
        key_col = keys.view(-1)[at].to(torch.int64)
        if pk2.dtype == torch.uint32:
            key_col &= 0xFFFFFFFF
        cols = [key_col, pv2.view(-1)[at].to(torch.int64),
                joined.view(-1)[at].to(torch.int64)]
        return torch.stack(cols, dim=1)

    # ------------------------------------------------------------------
    def place(
        self,
        build_keys: np.ndarray,
        build_vals: np.ndarray,
        probe_keys: np.ndarray,
        probe_vals: np.ndarray,
    ) -> Tuple[Tuple[torch.Tensor, ...], int, int]:
        """Pad each side to a multiple of E (keys with the padding key,
        values with ``miss_value``) and upload it: ``((bk, bv, pk, pv)
        shard stacks on the mesh's device, nb_local, np_local)``.

        uint64 keys with int64 payloads on both sides stay at 64 bits (a
        uint64 key tensor); uint64 keys beside anything else raise; every
        other input is cast to uint32 keys and int32 payloads."""
        e = self.num_shards
        width = _WIDTHS[self._key_dtype(build_keys, build_vals, probe_keys, probe_vals)]

        def shard_pad(x, fill):
            n = len(x)
            n_local = int(math.ceil(n / e))
            out = np.full((e * n_local,), fill, dtype=x.dtype)
            out[:n] = x
            # moved as its signed bit pattern (torch copies few unsigned
            # dtypes), viewed back on the device
            signed = torch.from_numpy(out.view(out.dtype.str.replace("u", "i")))
            return signed.to(self.device).view(torch_dtype(out.dtype)), n_local

        bk, nb = shard_pad(build_keys.astype(width.np_key), width.pad)
        bv, _ = shard_pad(build_vals.astype(width.np_val), self.miss_value)
        pk, npl = shard_pad(probe_keys.astype(width.np_key), width.pad)
        pv, _ = shard_pad(probe_vals.astype(width.np_val), self.miss_value)
        return (bk, bv, pk, pv), nb, npl

    @staticmethod
    def _key_dtype(build_keys, build_vals, probe_keys, probe_vals) -> torch.dtype:
        """uint64 where both sides carry uint64 keys with int64 payloads;
        uint32 where neither side's keys are uint64; else a ValueError."""
        wide = [np.asarray(k).dtype == np.uint64 for k in (build_keys, probe_keys)]
        if not any(wide):
            return torch.uint32
        vals = [np.asarray(v).dtype for v in (build_vals, probe_vals)]
        if not all(wide) or any(v != np.int64 for v in vals):
            raise ValueError(
                "HashJoin joins uint64 keys with int64 payloads on both sides, not keys "
                f"{np.asarray(build_keys).dtype} / {np.asarray(probe_keys).dtype} with "
                f"payloads {vals[0]} / {vals[1]}")
        return torch.uint64

    def join(
        self,
        build_keys: np.ndarray,
        build_vals: np.ndarray,
        probe_keys: np.ndarray,
        probe_vals: np.ndarray,
    ) -> np.ndarray:
        """Left-outer join; returns [m, 3] (probe_key, probe_val,
        build_val-or-miss) int64 rows, one per probe row whose key is not
        the padding key, in the JAX package's order (a uint64 key as its
        int64 bit pattern: ``out[:, 0].view(np.uint64)``). Retries with
        doubled bucket capacity on skew overflow."""
        e = self.num_shards
        t0 = time.perf_counter()
        args, nb, npl = self.place(build_keys, build_vals, probe_keys, probe_vals)
        t1 = time.perf_counter()
        cap_b = max(8, int(math.ceil(nb / e) * self.capacity_factor))
        cap_p = max(8, int(math.ceil(npl / e) * self.capacity_factor))
        self.last_capacities = []
        for _ in range(8):
            self.last_capacities.append((cap_b, cap_p))
            pk2, pv2, joined, pcnt, overflow = self.step(nb, npl, cap_b, cap_p)(*args)
            overflowed = bool(overflow)
            self._count_probes()
            if not overflowed:
                break
            del pk2, pv2, joined, pcnt
            cap_b *= 2
            cap_p *= 2
        else:
            raise RuntimeError("join bucket overflow after 8 capacity doublings")
        t2 = time.perf_counter()
        del args
        out = self._rows(pk2, pv2, joined, pcnt).cpu().numpy()
        self.last_walls = {"pad_upload_s": t1 - t0, "steps_s": t2 - t1,
                           "rows_readback_s": time.perf_counter() - t2}
        if not len(out):
            # the JAX package's np.array of no rows: shape (0,)
            return np.array([], dtype=np.int64)
        return out
