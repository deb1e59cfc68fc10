"""ProtectionDomain — the per-endpoint registered-memory handle table.

TPU-native analogue of the verbs protection domain (``IbvPd``) plus
memory-region registration (``IbvPd.regMr``) that the reference obtains
through DiSNI (reference: RdmaNode.java:99-104 allocates the PD;
RdmaBuffer.java:81-88 registers regions against it).

Registering a region yields an ``mkey`` (the rkey/lkey analogue). A
one-sided READ presented to this endpoint as ``(mkey, offset, length)``
is resolved directly against this table by the transport's passive IO
plane — the owning application code is never involved, preserving the
reference's "remote CPU does zero per-byte work" invariant
(SURVEY.md §5.1 #3).

A copy of the JAX package's ``memory/registry.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from sparkrdma_tpu_torch.obs import get_registry


class RegionError(KeyError):
    """Access through an unknown or out-of-range (mkey, offset, length)."""


_M_REGISTRATIONS = get_registry().counter("mempool.registrations")
_M_DEREGISTRATIONS = get_registry().counter("mempool.deregistrations")


class ProtectionDomain:
    """Handle table: mkey → registered memoryview."""

    # the pure-Python plane streams every READ; it never consumes
    # file_path hints, so buffers should not bother allocating shm
    # backing for it (NativeProtectionDomain overrides this)
    supports_file_regions = False

    _next_pd_id = 0
    _pd_lock = threading.Lock()

    def __init__(self):
        with ProtectionDomain._pd_lock:
            self.pd_id = ProtectionDomain._next_pd_id
            ProtectionDomain._next_pd_id += 1
        self._lock = threading.Lock()
        self._regions: Dict[int, memoryview] = {}
        self._next_mkey = 1  # 0 reserved as "unregistered"

    def register(
        self,
        view: memoryview,
        file_path: Optional[str] = None,
        file_offset: int = 0,
        file_mutable: bool = False,
        file_stat=None,
    ) -> int:
        """Register a memory region (read-only is fine); returns its mkey.

        ``file_path``/``file_offset``/``file_mutable``/``file_stat``
        describe a file whose bytes mirror the region (shm slab, mapped
        shuffle file). The pure-Python plane streams all READs and
        ignores them; the native plane uses them for the same-host
        pread fast path (transport.cpp srt_reg_file)."""
        del file_path, file_offset, file_mutable, file_stat  # python plane streams
        with self._lock:
            mkey = self._next_mkey
            self._next_mkey += 1
            self._regions[mkey] = view
        _M_REGISTRATIONS.inc()
        return mkey

    def deregister(self, mkey: int) -> None:
        with self._lock:
            removed = self._regions.pop(mkey, None)
        if removed is not None:
            _M_DEREGISTRATIONS.inc()

    def region_length(self, mkey: int) -> int:
        """Total byte length of a registered region (for local
        consumers that want the class-spanning view, not just the
        advertised valid prefix — see DeviceShuffleIO's local
        short-circuit)."""
        with self._lock:
            region = self._regions.get(mkey)
        if region is None:
            raise RegionError(f"mkey {mkey} not registered in pd {self.pd_id}")
        return len(region)

    def resolve(self, mkey: int, offset: int, length: int) -> memoryview:
        """Resolve (mkey, offset, length) → memory, bounds-checked.

        This is the NIC's address-translation step for an incoming READ.
        """
        with self._lock:
            region = self._regions.get(mkey)
        if region is None:
            raise RegionError(f"mkey {mkey} not registered in pd {self.pd_id}")
        if offset < 0 or length < 0 or offset + length > len(region):
            raise RegionError(
                f"READ [{offset}, {offset + length}) out of bounds for "
                f"mkey {mkey} (region size {len(region)})"
            )
        return region[offset : offset + length]

    def region_count(self) -> int:
        with self._lock:
            return len(self._regions)

    def dealloc(self) -> None:
        with self._lock:
            self._regions.clear()
