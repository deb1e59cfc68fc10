"""Ulysses-style sequence parallelism — the all-to-all SP schedule.

The PyTorch counterpart of the JAX package's ``ops/ulysses_attention.py``.
Ulysses re-shards with two all-to-alls: heads are scattered and the
sequence gathered, so each rank computes full-sequence attention for its
subset of heads (the flash kernel), then the output is re-sharded back
to the sequence. Requires ``num_heads % num_shards == 0``.

This slice runs one rank, where both exchanges are the identity and the
schedule *is* :func:`flash_attention`. The two ``all_to_all``s ride
``torch.distributed`` once the host-plane slice brings the process
group; more ranks raise ``NotImplementedError`` until then.

Gradients flow through the schedule: :func:`flash_attention`'s backward
is the flash kernels' (dq, then dk/dv), and an ``all_to_all`` is its own
transpose, so the multi-rank form differentiates the same way.
"""

from __future__ import annotations

import torch

from sparkrdma_tpu_torch.ops.pallas_attention import flash_attention
from sparkrdma_tpu_torch.ops.ring_attention import reference_attention
from sparkrdma_tpu_torch.utils.torch_compat import resolve_device


def ulysses_shard_attention(q, k, v, num_shards: int = 1, causal: bool = False,
                            use_flash: bool = True) -> torch.Tensor:
    """The shard-local Ulysses schedule: seq-gather / head-scatter
    (``[B, s, H, D] -> [B, s * E, H / E, D]``), full-sequence attention
    per head group (the flash kernel, or the dense reference with
    ``use_flash=False``), and the inverse exchange."""
    h = q.shape[2]
    if h % num_shards:
        raise ValueError(
            f"num_heads {h} must divide by shard count {num_shards}"
        )
    if num_shards != 1:
        raise NotImplementedError(
            "Ulysses over more than one rank needs the all_to_all of the "
            "host-plane slice's torch.distributed group"
        )
    if use_flash:
        return flash_attention(q, k, v, causal=causal)
    return reference_attention(q, k, v, causal=causal)


class UlyssesAttention:
    """All-to-all sequence-parallel attention over ``world_size`` ranks
    (one, in this slice). Inputs are ``[B, S, H, D]``; ``__call__`` moves
    them to ``self.device`` (``cuda`` unless ``device="cpu"`` was asked
    for). A tensor already there is used as it is, so its autograd graph
    is kept."""

    def __init__(self, world_size: int = 1, device=None):
        if world_size != 1:
            raise NotImplementedError(
                "UlyssesAttention over more than one rank needs the "
                "torch.distributed groups of the multi-GPU slice"
            )
        self.num_shards = world_size
        self.device = resolve_device(device)

    def __call__(self, q, k, v, causal: bool = False,
                 use_flash: bool = True) -> torch.Tensor:
        q, k, v = (torch.as_tensor(x, device=self.device) for x in (q, k, v))
        return ulysses_shard_attention(q, k, v, self.num_shards,
                                       causal=causal, use_flash=use_flash)
