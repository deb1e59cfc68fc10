"""Block integrity checksums for the resilient fetch path.

The wire carries an *algo-tagged* checksum per block (docs/RESILIENCE.md)
so publisher and fetcher may disagree on available implementations
without breaking: a fetcher that cannot compute the publisher's algo
treats the block as unverifiable and passes it through, exactly like a
legacy frame with no checksum at all.

Algorithms:
  0 — none (legacy frames / checksums disabled)
  1 — crc32c (Castagnoli; hardware-accelerated ``crc32c`` package)
  2 — crc32 (zlib; always available)

crc32c is the reference-grade choice (what RDMA NICs and Spark's own
shuffle integrity use); without the native package we fall back to
zlib's C crc32 rather than a pure-Python table walk, which would cost
seconds per 8 MiB block.

A copy of the JAX package's ``utils/checksum.py``, its imports rewritten
to this package.
"""

from __future__ import annotations

import zlib
from typing import Tuple

ALGO_NONE = 0
ALGO_CRC32C = 1
ALGO_CRC32 = 2

try:  # optional accelerator; never a hard dependency
    import crc32c as _crc32c_mod  # type: ignore

    _HAVE_CRC32C = True
except ImportError:
    _crc32c_mod = None
    _HAVE_CRC32C = False

DEFAULT_ALGO = ALGO_CRC32C if _HAVE_CRC32C else ALGO_CRC32


def compute(data, algo: int = None) -> Tuple[int, int]:
    """Checksum ``data`` (any buffer) -> (algo, crc32 value).

    ``algo=None`` picks the best available implementation; an explicitly
    requested but unavailable algo degrades to (ALGO_NONE, 0) rather
    than raising — integrity is best-effort by design.
    """
    if algo is None:
        algo = DEFAULT_ALGO
    if algo == ALGO_CRC32C and _HAVE_CRC32C:
        return ALGO_CRC32C, _crc32c_mod.crc32c(bytes(data)) & 0xFFFFFFFF
    if algo == ALGO_CRC32:
        return ALGO_CRC32, zlib.crc32(data) & 0xFFFFFFFF
    return ALGO_NONE, 0


def verify(data, checksum: int, algo: int) -> bool:
    """True if ``data`` matches, or if the block is unverifiable.

    Unverifiable = no checksum attached (ALGO_NONE), or an algo this
    process cannot compute. Both pass: the checksum extension must
    never make mixed-version clusters worse than no checksums at all.
    """
    if algo == ALGO_NONE:
        return True
    if algo == ALGO_CRC32C:
        if not _HAVE_CRC32C:
            return True
        return (_crc32c_mod.crc32c(bytes(data)) & 0xFFFFFFFF) == checksum
    if algo == ALGO_CRC32:
        return (zlib.crc32(data) & 0xFFFFFFFF) == checksum
    return True  # unknown future algo: unverifiable
