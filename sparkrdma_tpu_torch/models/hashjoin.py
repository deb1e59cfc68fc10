"""Device-resident distributed hash join — the shuffle-heavy join workload.

The PyTorch counterpart of the JAX package's ``models/hashjoin.py``
(TPC-DS q64/q72's shuffle-heavy hash joins). Both sides radix-partition
on the key's top bits, every shard of a side in one ``radix_pack_pairs``
call (on CUDA one hand-written pack kernel, keys and payloads together),
and ride one all-to-all each (``ExchangeProgram`` over the shard
stack); the local join sorts the build side and binary-searches the
probes.

Join shape: the build side has UNIQUE keys (the dimension-table case);
every probe row matches at most one build row, so the output is exactly
probe-sized. Probe rows with no match return ``miss_value`` (left-outer
semantics). The output rows are the JAX package's, in its order.

A step opens spans (``obs/trace.py`` ``span``): ``hashjoin.step`` once
around ``_build``'s ``fn``, the whole step; directly in it
``hashjoin.pack`` once a side (``radix_pack_pairs``: every shard's keys
and payloads), ``hashjoin.build_sort`` once (the build keys' mask,
``device_argsort``, the two gathers), ``hashjoin.probe`` once
(``searchsorted``, the clamp, the gathers, ``hit``, ``joined``), and the
exchange's ``exchange.a2a`` four times.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.models.terasort import KEY_BITS, SENTINEL
from sparkrdma_tpu_torch.obs.trace import span
from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram
from sparkrdma_tpu_torch.ops.sort import device_argsort, radix_pack_pairs, searchsorted
from sparkrdma_tpu_torch.parallel.mesh import ShardMesh, mesh_or_one_shard

_SENTINEL_BITS = -1  # SENTINEL as its int32 bit pattern


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

    # ------------------------------------------------------------------
    def _build(self, nb_local: int, np_local: int, cap_b: int, cap_p: int):
        e = self.num_shards
        miss = self.miss_value

        def scatter(keys: torch.Tensor, vals: torch.Tensor, cap: int):
            # keys/vals: [E, n_local] shard stacks; every shard packs its
            # rows by destination in one call and the slabs ride one
            # all-to-all
            with span("hashjoin.pack"):
                kslab, vslab, counts, flags = radix_pack_pairs(
                    keys, vals, e, cap, KEY_BITS, key_fill=SENTINEL, val_fill=miss)
            a2a = self._exchange.program_for(e, cap, torch.int32)
            k2, c2 = a2a(kslab.view(torch.int32).view(e * e, cap), counts.view(-1))
            del kslab
            v2, _ = a2a(vslab.view(e * e, cap), counts.view(-1))
            return k2.view(e, e, cap), v2.view(e, e, cap), c2.view(e, e), flags.any()

        def valid(cnt: torch.Tensor, cap: int) -> torch.Tensor:
            col = torch.arange(cap, dtype=torch.int32, device=cnt.device)
            return (col[None, None, :] < cnt[:, :, None]).view(e, -1)

        def fn(bk, bv, pk, pv):
            # bk/pk: [E * n_local] uint32 stacks; bv/pv: int32
            with span("hashjoin.step"):
                for x, n in ((bk, nb_local), (bv, nb_local), (pk, np_local),
                             (pv, np_local)):
                    if x.shape != (e * n,):
                        raise ValueError(f"step built for [{e * n}], got {list(x.shape)}")
                bk2, bv2, bcnt, ovf_b = scatter(bk.view(e, -1), bv.view(e, -1), cap_b)
                pk2, pv2, pcnt, ovf_p = scatter(pk.view(e, -1), pv.view(e, -1), cap_p)
                # any shard overflowing aborts the round everywhere (the pmax)
                overflow = (ovf_b | ovf_p).to(torch.int32)

                # local join, every shard at once: sort the build side (the
                # padding masked to SENTINEL), binary-search the probes
                with span("hashjoin.build_sort"):
                    bkeys = torch.where(valid(bcnt, cap_b), bk2.view(e, -1),
                                        _SENTINEL_BITS).view(torch.uint32)
                    order = device_argsort(bkeys)
                    bkeys_s = torch.gather(bkeys.view(torch.int32), 1, order)
                    bvals_s = torch.gather(bv2.view(e, -1), 1, order)
                    del bkeys, order
                with span("hashjoin.probe"):
                    pkeys = pk2.view(e, -1)
                    pos = searchsorted(bkeys_s.view(torch.uint32),
                                       pkeys.view(torch.uint32))
                    pos = pos.clamp_(max=bkeys_s.shape[1] - 1).to(torch.int64)
                    hit = (torch.gather(bkeys_s, 1, pos) == pkeys) & valid(pcnt, cap_p)
                    joined = torch.where(hit, torch.gather(bvals_s, 1, pos), miss)
                # [E, E, cap_p] rows aligned with pk2/pv2: shard d's row s is
                # what shard s sent it, its first pcnt[d, s] slots valid
                return (pk2.view(torch.uint32), pv2, joined.view(e, e, cap_p), pcnt,
                        overflow)

        return fn

    def step(self, nb_local: int, np_local: int, cap_b: int, cap_p: int) -> Callable:
        """The cached join step ``fn(bk, bv, pk, pv) -> (pk2, pv2, joined,
        pcnt, overflow)`` over ``[E * n_local]`` shard stacks on the
        mesh's device."""
        key = (nb_local, np_local, cap_b, cap_p)
        fn = self._cache.get(key)
        if fn is None:
            fn = self._build(nb_local, np_local, cap_b, cap_p)
            self._cache[key] = fn
        return fn

    def _rows(self, pk2, pv2, joined, pcnt) -> torch.Tensor:
        """The ``[m, 3]`` int64 output rows on the device: every valid slot
        whose key is not SENTINEL (``shard_pad``'s padding), in (dest
        shard, source shard, slot) order — the JAX package's triple loop
        as one mask."""
        cap = pk2.shape[-1]
        col = torch.arange(cap, dtype=torch.int32, device=pk2.device)
        keys = pk2.view(torch.int32)
        take = ((col < pcnt[..., None]) & (keys != _SENTINEL_BITS)).view(-1)
        at = take.nonzero().squeeze(1)
        del take
        cols = [keys.view(-1)[at].to(torch.int64) & 0xFFFFFFFF,
                pv2.view(-1)[at].to(torch.int64),
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
        """Pad each side to a multiple of E (keys with SENTINEL, values
        with ``miss_value``) and upload it: ``((bk, bv, pk, pv) shard
        stacks on the mesh's device, nb_local, np_local)``."""
        e = self.num_shards

        def shard_pad(x, fill):
            n = len(x)
            n_local = int(math.ceil(n / e))
            dtype = np.uint32 if fill == int(SENTINEL) else np.int32
            out = np.full((e * n_local,), fill, dtype=dtype)
            out[:n] = x
            return torch.from_numpy(out).to(self.device), n_local

        bk, nb = shard_pad(build_keys.astype(np.uint32), int(SENTINEL))
        bv, _ = shard_pad(build_vals.astype(np.int32), self.miss_value)
        pk, npl = shard_pad(probe_keys.astype(np.uint32), int(SENTINEL))
        pv, _ = shard_pad(probe_vals.astype(np.int32), self.miss_value)
        return (bk, bv, pk, pv), nb, npl

    def join(
        self,
        build_keys: np.ndarray,
        build_vals: np.ndarray,
        probe_keys: np.ndarray,
        probe_vals: np.ndarray,
    ) -> np.ndarray:
        """Left-outer join; returns [m, 3] (probe_key, probe_val,
        build_val-or-miss) int64 rows, one per probe row whose key is not
        SENTINEL, in the JAX package's order. Retries with doubled bucket
        capacity on skew overflow."""
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
            if not bool(overflow):
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
