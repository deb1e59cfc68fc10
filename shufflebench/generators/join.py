"""``join``: a build side with unique keys and a probe side of foreign
keys into it.

- Build side: ``config["build_rows"]`` rows, the keys ``1..B`` in a
  random order, hashed by the Fibonacci bijection (``x * 0x9E3779B1
  mod 2^32``), each with its row id as payload.
- Probe side: ``config["probe_rows"]`` rows, each the key of a build
  row drawn by ``traffic["probe_keys"]`` (a distribution of
  ``generator.draw`` over the B build rows), each with its own row id.

Returns ``build_keys``/``probe_keys`` (uint32) and ``build_vals``/
``probe_vals`` (int32)."""

from __future__ import annotations

from typing import Dict

import torch

from shufflebench.generator import as_u32, draw, fibonacci

PADDING = 0xFFFFFFFF  # the program's padding key; no hashed key may be it


def make(traffic: Dict, config: Dict, g, device) -> Dict[str, torch.Tensor]:
    b, p = int(config["build_rows"]), int(config["probe_rows"])
    bk = fibonacci(torch.randperm(b, generator=g, device=device) + 1)
    if bool((bk == PADDING).any()):
        raise ValueError("a hashed build key is the padding key")
    rows = draw(p, traffic["probe_keys"], b, g, device)
    probe_keys = as_u32(bk[rows])
    del rows
    return {
        "build_keys": as_u32(bk),
        "build_vals": torch.arange(b, dtype=torch.int32, device=device),
        "probe_keys": probe_keys,
        "probe_vals": torch.arange(p, dtype=torch.int32, device=device),
    }
