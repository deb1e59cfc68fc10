"""The one traffic generator.

A traffic file (``traffic/<name>.json``) holds parameters only. Its
``kind`` names the module ``generators/<kind>.py`` that turns them, the
configuration's sizes and ``--seed`` into the cell's inputs, made on
the device by a ``torch.Generator`` on it, in a few large calls. The
same seed gives the same inputs; every seed gives the same sizes. A new
kind of input is a new file there.

The helpers below are shared by the kinds. A distribution (``draw``)
is ``{"distribution": ...}``:

- ``uniform``: draws with replacement, every value alike;
- ``zipf`` (with ``s``): ranks by a Zipf law of exponent ``s``,
  continuous inverse-CDF approximation;
- ``each_once``: the values ``i mod support`` for ``i < n``, in a
  random order (with ``n == support``, a permutation: every value
  once).
"""

from __future__ import annotations

from typing import Dict

import torch

from shufflebench import cells

FIBONACCI = 0x9E3779B1  # odd, so multiplication mod 2^32 is a bijection


def seeded(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32, as a uint32 tensor."""
    lo = x & 0xFFFFFFFF
    return (lo - ((lo >> 31) << 32)).to(torch.int32).view(torch.uint32)


def fibonacci(ids: torch.Tensor) -> torch.Tensor:
    """``ids * 0x9E3779B1 mod 2^32`` (int64 in, int64 in [0, 2^32) out;
    a wrapped int64 product keeps its low 32 bits)."""
    return ((ids & 0xFFFFFFFF) * FIBONACCI) & 0xFFFFFFFF


def zipf_ranks(n: int, s: float, support: int, g, device) -> torch.Tensor:
    """``n`` ranks in ``[0, support)`` with P(rank k) ~ (k + 1)^-s."""
    if s == 1.0:
        raise ValueError("zipf takes s != 1")
    u = torch.rand((n,), dtype=torch.float64, generator=g, device=device)
    a = 1.0 - s
    top = float(support + 1) ** a
    x = (1.0 + u * (top - 1.0)) ** (1.0 / a)
    return (x.floor().to(torch.int64) - 1).clamp_(0, support - 1)


def draw(n: int, dist: Dict, support: int, g, device) -> torch.Tensor:
    """``n`` int64 draws in ``[0, support)`` by ``dist``."""
    kind = dist["distribution"]
    if kind == "uniform":
        return torch.randint(0, support, (n,), dtype=torch.int64, generator=g,
                             device=device)
    if kind == "zipf":
        return zipf_ranks(n, float(dist["s"]), support, g, device)
    if kind == "each_once":
        return torch.randperm(n, generator=g, device=device).remainder_(support)
    raise ValueError(f"unknown distribution {kind!r}")


def make(traffic: Dict, config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The cell's inputs on ``device``, by ``generators/<kind>.py``."""
    kind = cells.generator_module(traffic["kind"])
    return kind.make(traffic, config, seeded(seed, device), device)
