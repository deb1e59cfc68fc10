"""``graph``: the Graph500 Kronecker edge list (graph500.org
specification, section 3, its reference ``kronecker_generator``).

``config["scale"]`` levels over ``m = config["edgefactor"] *
2^scale`` edges; at each level every edge draws two uniforms and sets
one bit of its start and one of its end vertex by the initiator
``config["initiator"]`` = (A, B, C, D): the start bit is 1 with
probability C + D, the end bit then with probability D / (C + D),
else B / (A + B). The levels are drawn one at a time, so their draws
are never held at once. The vertex labels are then permuted by one
``randperm`` of the ``2^scale`` vertices. The spec's final shuffle of
the edges is left out: every edge is drawn on its own, so their order
is already random. Self-loops and duplicate edges are kept.

Returns ``{"edges": [m, 2] int32}``, each row ``(start, end)``."""

from __future__ import annotations

from typing import Dict

import torch


def make(traffic: Dict, config: Dict, g, device) -> Dict[str, torch.Tensor]:
    scale = int(config["scale"])
    n = 1 << scale
    m = int(config["edgefactor"]) * n
    a, b, c, d = (float(x) for x in config["initiator"])
    if abs(a + b + c + d - 1.0) > 1e-9:
        raise ValueError(f"initiator {config['initiator']} does not sum to 1")
    ab, c_norm, a_norm = a + b, c / (c + d), a / (a + b)
    ends = [torch.zeros((m,), dtype=torch.int32, device=device) for _ in range(2)]
    u = torch.empty((m,), dtype=torch.float32, device=device)
    for level in range(scale):
        u.uniform_(generator=g)
        start_bit = u > ab
        u.uniform_(generator=g)
        end_bit = torch.where(start_bit, u > c_norm, u > a_norm)
        for col, bit in zip(ends, (start_bit, end_bit)):
            col.bitwise_or_(bit.to(torch.int32).bitwise_left_shift_(level))
        del start_bit, end_bit
    del u
    label = torch.randperm(n, generator=g, device=device).to(torch.int32)
    edges = torch.empty((m, 2), dtype=torch.int32, device=device)
    for j, col in enumerate(ends):
        edges[:, j] = torch.index_select(label, 0, col)
    return {"edges": edges}
