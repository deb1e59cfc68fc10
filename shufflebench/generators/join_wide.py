"""``join_wide``: the ``join`` kind at 8-byte rows, a build side with
unique uint64 keys and a probe side of foreign keys into it.

- Build side: ``config["build_rows"]`` rows, the keys ``1..B`` in a
  random order, hashed by the 64-bit Fibonacci bijection (``x *
  0x9E3779B97F4A7C15 mod 2^64``), each with its row id as payload.
- Probe side: ``config["probe_rows"]`` rows, each the key of a build
  row drawn by ``traffic["probe_keys"]`` (a distribution of
  ``generator.draw`` over the B build rows), each with its own row id.

Returns ``build_keys``/``probe_keys`` (uint64) and ``build_vals``/
``probe_vals`` (int64). The keys are computed as int64 (the product
wraps mod 2^64) and viewed as uint64."""

from __future__ import annotations

from typing import Dict

import torch

from shufflebench.generator import draw

FIBONACCI64 = 0x9E3779B97F4A7C15  # odd, so multiplication mod 2^64 is a bijection
PADDING = -1  # the program's padding key 0xFFFF_FFFF_FFFF_FFFF as an int64


def fibonacci64(ids: torch.Tensor) -> torch.Tensor:
    """``ids * 0x9E3779B97F4A7C15 mod 2^64`` as the int64 bit pattern."""
    return ids * (FIBONACCI64 - (1 << 64))


def make(traffic: Dict, config: Dict, g, device) -> Dict[str, torch.Tensor]:
    b, p = int(config["build_rows"]), int(config["probe_rows"])
    bk = fibonacci64(torch.randperm(b, generator=g, device=device) + 1)
    if bool((bk == PADDING).any()):
        raise ValueError("a hashed build key is the padding key")
    rows = draw(p, traffic["probe_keys"], b, g, device)
    probe_keys = bk[rows]
    del rows
    return {
        "build_keys": bk.view(torch.uint64),
        "build_vals": torch.arange(b, dtype=torch.int64, device=device),
        "probe_keys": probe_keys.view(torch.uint64),
        "probe_vals": torch.arange(p, dtype=torch.int64, device=device),
    }
