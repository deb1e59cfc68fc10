"""Ring attention — sequence-parallel exact attention over a mesh axis.

The PyTorch counterpart of the JAX package's ``ops/ring_attention.py``.
The sequence is sharded over one axis of a :class:`ShardMesh`; each shard
holds one query block and streams every peer's key/value block around
the ring, folding each into a blockwise online softmax (running max,
numerator, denominator), so the result is exact attention with
O(seq / E) memory per shard.

The shards are rows of one stack on one device (``parallel/mesh.py``).
Each hop moves every shard's kv block to its right neighbour on the
axis (``lax.ppermute`` with ``perm = [(i, (i + 1) % E)]``): on a CUDA
mesh one ``srt_neighbor_pull`` launch for k and one for v, through
``remote_copy.PPermute``, whose backward is the inverse permutation on
the same kernel; on a CPU mesh its plain version. The hops run in the
JAX order: at hop ``h`` shard ``me`` holds the block of shard ``(me - h)
mod E``. ``reference_attention`` is the dense single-device attention
the tests hold everything against.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from sparkrdma_tpu_torch.ops.remote_copy import PPermute, axis_shift_perm
from sparkrdma_tpu_torch.parallel.mesh import ShardMesh, mesh_or_one_shard, shard, unshard

NEG_INF = -1e30


def _block_attn(q, k, v, mask, m_prev, num_prev, den_prev):
    """One blockwise online-softmax accumulation step, in f32.

    q: [..., Sq, H, D]; k/v: [..., Sk, H, D]; mask: additive, broadcast
    to the scores [..., H, Sq, Sk]. Carries: m (running max) [..., H, Sq],
    num [..., Sq, H, D], den [..., H, Sq].
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float())
    s = s * scale + mask
    m_new = torch.maximum(m_prev, s.amax(-1))
    # renormalize the previous accumulator to the new max
    correction = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new[..., None])  # [..., H, Sq, Sk]
    num = num_prev * correction.transpose(-1, -2)[..., None] + torch.einsum(
        "...hqk,...khd->...qhd", p, v.float()
    )
    den = den_prev * correction + p.sum(-1)
    return m_new, num, den


def _hop(stack: torch.Tensor, perm) -> torch.Tensor:
    """One ring hop of a ``[*mesh, ...]`` stack: a single permutation
    launch over its flat ``[E, ...]`` view."""
    n = math.prod(stack.shape[: -4])
    return PPermute.apply(stack.reshape(n, -1), perm).reshape(stack.shape)


def ring_shard_attention(q, k, v, mesh_shape: Sequence[int], dim: int,
                         causal: bool = False) -> torch.Tensor:
    """The ring schedule on shard stacks ``[*mesh_shape, B, s, H, D]``,
    ring over mesh axis ``dim`` (the other axes run the same schedule on
    their own rows). Returns the stack of outputs in q's dtype. Both
    :class:`RingAttention` and the training step's ring call this."""
    mesh_shape = tuple(mesh_shape)
    e = mesh_shape[dim]
    lead = q.shape[:-3]
    s_loc, h, d = q.shape[-3:]
    dev = q.device
    m = torch.full((*lead, h, s_loc), NEG_INF, dtype=torch.float32, device=dev)
    num = torch.zeros((*lead, s_loc, h, d), dtype=torch.float32, device=dev)
    den = torch.zeros((*lead, h, s_loc), dtype=torch.float32, device=dev)
    # shard me's index on the ring axis, broadcast over the other axes
    me = torch.arange(e, device=dev).reshape(
        [e if i == dim else 1 for i in range(len(mesh_shape))])
    pos = torch.arange(s_loc, device=dev)
    q_pos = me[..., None] * s_loc + pos
    perm = axis_shift_perm(mesh_shape, dim, 1)
    k_blk, v_blk = k, v
    for hop in range(e):
        if causal:
            src = (me - hop) % e  # which shard's kv block we hold now
            kv_pos = src[..., None] * s_loc + pos
            mask = torch.where(q_pos[..., :, None] >= kv_pos[..., None, :],
                               0.0, NEG_INF).float()
            mask = mask[..., None, None, :, :]  # over B and H
        else:
            mask = torch.zeros((s_loc, s_loc), dtype=torch.float32, device=dev)
        m, num, den = _block_attn(q, k_blk, v_blk, mask, m, num, den)
        if hop != e - 1:
            k_blk = _hop(k_blk, perm)
            v_blk = _hop(v_blk, perm)
    out = num / den.transpose(-1, -2)[..., None]
    return out.to(q.dtype)


class RingAttention:
    """Exact ring attention over one axis of a mesh (default: its last).
    ``mesh=None`` is one shard on ``device`` (``cuda`` unless
    ``device="cpu"`` is asked for). Inputs are global ``[B, S, H, D]``;
    ``__call__`` moves them to the mesh's device, splits the sequence over
    the axis, replicates over the other axes and returns the global
    output. A tensor already on that device keeps its autograd graph."""

    def __init__(self, mesh: Optional[ShardMesh] = None,
                 axis: Optional[str] = None, device=None):
        self.mesh = mesh_or_one_shard(mesh, device)
        self.axis = self.mesh.axis_names[-1] if axis is None else axis
        self.num_shards = self.mesh.shape[self.axis]
        self.device = self.mesh.device

    def __call__(self, q, k, v, causal: bool = False) -> torch.Tensor:
        """Exact attention over ``[B, S, H, D]`` inputs; the output has
        q's shape and dtype."""
        spec = (None, self.axis)
        stacks = [shard(self.mesh, torch.as_tensor(x, device=self.device), spec)
                  for x in (q, k, v)]
        out = ring_shard_attention(*stacks, self.mesh.axis_sizes,
                                   self.mesh.axis_index(self.axis), causal)
        return unshard(self.mesh, out, spec)


def reference_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Dense single-device attention for correctness checks. The scores'
    einsum runs in the input dtype before the f32 cast, as in the JAX
    package."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        n = q.shape[1]
        pos = torch.arange(n, device=q.device)
        mask = torch.where(pos[:, None] >= pos[None, :], 0.0, NEG_INF).float()
        s = s + mask[None, None]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
