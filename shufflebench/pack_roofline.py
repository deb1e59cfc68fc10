"""The 8-byte pack kernel's roofline in ``join.pkfk.u64.256m``.

The bytes a stage's packs need, from the shapes: every key and payload
read once, ``row_bytes * (|R| + |S|)``, and both sides' two slabs
written, padding included, ``row_bytes * E * E * (cap_b + cap_p)``;
what the kernel reads again (its histogram's pass over the keys) is not
counted. Over the card's 3.35 TB/s (H100 SXM data sheet) that is the
bound; the time is the device time of ``srt_radix_pack64``'s kernels
(``radix_hist``, ``radix_scan``, ``radix_scatter`` at ``long long``
rows, by the names the trace gives them) a stage, in stretch ``a``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12
CAPACITY_FACTOR = 2.0  # the entry's HashJoin capacity_factor, join()'s first class
KERNELS = re.compile(r"radix_(?:hist|scan|scatter)<long long")


def capacities(config: Dict, factor: float = CAPACITY_FACTOR) -> Tuple[int, int, int, int]:
    """``(nb_local, np_local, cap_b, cap_p)`` as ``HashJoin.place`` and
    ``join()``'s first try set them."""
    e = int(config["shards"])
    nb = math.ceil(int(config["build_rows"]) / e)
    npl = math.ceil(int(config["probe_rows"]) / e)
    cap_b = max(8, int(math.ceil(nb / e) * factor))
    cap_p = max(8, int(math.ceil(npl / e) * factor))
    return nb, npl, cap_b, cap_p


def pack_bytes(config: Dict) -> int:
    """Bytes a stage's two packs need (both sides)."""
    row = int(config["key_bytes"]) + int(config["payload_bytes"])
    e = int(config["shards"])
    _, _, cap_b, cap_p = capacities(config)
    read = row * (int(config["build_rows"]) + int(config["probe_rows"]))
    written = row * e * e * (cap_b + cap_p)
    return read + written


def bound_ms(config: Dict) -> float:
    return pack_bytes(config) / HBM_BYTES_PER_S * 1e3


def kernel_ms(run) -> Optional[float]:
    """Device ms a stage of the 8-byte pack's kernels in stretch ``a``;
    None where none ran."""
    if run.traced is None:
        return None
    a = run.traced["a"]
    ns = sum(e.end_ns - e.start_ns for e in a.events
             if e.kind == "device" and KERNELS.search(e.name))
    return ns / 1e6 / a.stages if ns else None


def roofline_share(run) -> Optional[float]:
    """The bound over the kernels' time, in %."""
    ms = kernel_ms(run)
    return None if ms is None else bound_ms(run.cell.config) / ms * 100.0
