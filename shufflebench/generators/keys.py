"""``keys``: ``config["records"]`` uint32 keys, ``{"keys": ...}``.

``traffic["keys"]`` is the distribution: ``{"distribution":
"uniform"}`` (every 32-bit pattern alike) or ``{"distribution": "zipf",
"s": 1.1, "support": N}`` (ranks ``0..N-1`` by a Zipf law, each hashed
to a key by the Fibonacci bijection)."""

from __future__ import annotations

from typing import Dict

import torch

from shufflebench.generator import as_u32, fibonacci, zipf_ranks


def make(traffic: Dict, config: Dict, g, device) -> Dict[str, torch.Tensor]:
    n = int(config["records"])
    dist = traffic["keys"]
    kind = dist["distribution"]
    if kind == "uniform":
        keys = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                             generator=g, device=device).view(torch.uint32)
    elif kind == "zipf":
        ranks = zipf_ranks(n, float(dist["s"]), int(dist["support"]), g, device)
        keys = as_u32(fibonacci(ranks))
    else:
        raise ValueError(f"unknown key distribution {kind!r}")
    return {"keys": keys}
