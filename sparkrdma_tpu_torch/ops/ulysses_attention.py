"""Ulysses-style sequence parallelism — the all-to-all SP schedule.

The PyTorch counterpart of the JAX package's ``ops/ulysses_attention.py``.
Ulysses re-shards with two all-to-alls instead of the ring's hops: heads
are scattered and the sequence gathered, so each shard computes
full-sequence attention for its subset of heads, then the output is
re-sharded back to the sequence. Requires ``num_heads % num_shards == 0``.

The shards are rows of one stack on one device (``parallel/mesh.py``),
so each all-to-all (``lax.all_to_all(split_axis=2, concat_axis=1,
tiled=True)``, an XLA collective in the reference) is one ``permute`` +
``contiguous`` of the stack, and the attention of every shard is one
:func:`flash_attention` call with the shards folded into the batch: one
flash forward launch per call, one dq and one dk/dv launch per backward,
on the route ``fwd_entry`` / ``bwd_entry`` pick. Gradients flow through
the schedule: a permutation's adjoint is its inverse, and
:func:`flash_attention`'s backward is the flash kernels'.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparkrdma_tpu_torch.ops.pallas_attention import flash_attention
from sparkrdma_tpu_torch.ops.ring_attention import reference_attention
from sparkrdma_tpu_torch.parallel.mesh import ShardMesh, mesh_or_one_shard, shard, unshard


def _seq_gather_head_scatter(x: torch.Tensor, dim: int, e: int) -> torch.Tensor:
    """``[.., E (dim), .., B, s, H, D] -> [.., E, .., B, s * E, H / E, D]``:
    head chunk ``j`` of shard ``i`` lands as sequence chunk ``i`` of shard
    ``j``."""
    x = x.movedim(dim, 0)
    *lead, b, s, h, d = x.shape
    r = len(lead) - 1
    x = x.reshape(*lead, b, s, e, h // e, d)
    # [i, R.., B, s, j, h', D] -> [j, R.., B, i, s, h', D]
    x = x.permute(r + 3, *range(1, r + 1), r + 1, 0, r + 2, r + 4, r + 5)
    x = x.reshape(e, *lead[1:], b, e * s, h // e, d)
    return x.movedim(0, dim).contiguous()


def _head_gather_seq_scatter(y: torch.Tensor, dim: int, e: int) -> torch.Tensor:
    """The inverse exchange, ``[.., E, .., B, s * E, H / E, D] -> [.., E,
    .., B, s, H, D]``."""
    y = y.movedim(dim, 0)
    *lead, b, seq, hh, d = y.shape
    r = len(lead) - 1
    y = y.reshape(*lead, b, e, seq // e, hh, d)
    # [j, R.., B, i, s, h', D] -> [i, R.., B, s, j, h', D]
    y = y.permute(r + 2, *range(1, r + 1), r + 1, r + 3, 0, r + 4, r + 5)
    y = y.reshape(e, *lead[1:], b, seq // e, e * hh, d)
    return y.movedim(0, dim).contiguous()


def ulysses_shard_attention(q, k, v, dim: int, num_shards: int,
                            causal: bool = False,
                            use_flash: bool = True) -> torch.Tensor:
    """The Ulysses schedule on shard stacks ``[*mesh, B, s, H, D]`` whose
    mesh axis ``dim`` (of size ``num_shards``) splits the sequence:
    seq-gather / head-scatter (``[B, s, H, D] -> [B, s * E, H / E, D]`` a
    shard), full-sequence attention per head group (the flash kernel, or
    the dense reference with ``use_flash=False``), and the inverse
    exchange. Both :class:`UlyssesAttention` and the training step's
    Ulysses schedule call this one implementation."""
    h = q.shape[-2]
    if h % num_shards:
        raise ValueError(
            f"num_heads {h} must divide by shard count {num_shards}"
        )
    if num_shards > 1:
        q, k, v = (_seq_gather_head_scatter(t, dim, num_shards) for t in (q, k, v))
    lead = q.shape[:-3]
    fold = [t.reshape(-1, *t.shape[-3:]) for t in (q, k, v)]
    if use_flash:
        out = flash_attention(*fold, causal=causal)
    else:
        out = reference_attention(*fold, causal=causal)
    out = out.reshape(*lead, *out.shape[-3:])
    if num_shards > 1:
        out = _head_gather_seq_scatter(out, dim, num_shards)
    return out


class UlyssesAttention:
    """All-to-all sequence-parallel attention over one axis of a mesh
    (default: its last). ``mesh=None`` is one shard on ``device``
    (``cuda`` unless ``device="cpu"`` is asked for). Inputs are global
    ``[B, S, H, D]``; ``__call__`` moves them to the mesh's device, splits
    the sequence over the axis, replicates over the other axes and
    returns the global output. A tensor already on that device keeps its
    autograd graph."""

    def __init__(self, mesh: Optional[ShardMesh] = None,
                 axis: Optional[str] = None, device=None):
        self.mesh = mesh_or_one_shard(mesh, device)
        self.axis = self.mesh.axis_names[-1] if axis is None else axis
        self.num_shards = self.mesh.shape[self.axis]
        self.device = self.mesh.device

    def __call__(self, q, k, v, causal: bool = False,
                 use_flash: bool = True) -> torch.Tensor:
        spec = (None, self.axis)
        stacks = [shard(self.mesh, torch.as_tensor(x, device=self.device), spec)
                  for x in (q, k, v)]
        out = ulysses_shard_attention(*stacks, self.mesh.axis_index(self.axis),
                                      self.num_shards, causal=causal,
                                      use_flash=use_flash)
        return unshard(self.mesh, out, spec)
