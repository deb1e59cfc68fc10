"""Ring attention — sequence-parallel exact attention.

The PyTorch counterpart of the JAX package's ``ops/ring_attention.py``.
The sequence is sharded over the ranks; each rank holds one query block
and streams every peer's key/value block around the ring, folding each
into a blockwise online softmax (running max, numerator, denominator),
so the result is exact attention with O(seq / world) memory per rank.

This slice runs one rank: the one-hop schedule, where the rank's own
kv block is the whole sequence. More ranks need the process groups of
the host-plane slice and raise ``NotImplementedError``.
``reference_attention`` is the dense single-device attention the tests
hold everything against. Both are plain torch ops, differentiated by
autograd; a tensor already on the class's device keeps its graph.
"""

from __future__ import annotations

import math

import torch

from sparkrdma_tpu_torch.utils.torch_compat import resolve_device

NEG_INF = -1e30


def _block_attn(q, k, v, mask, m_prev, num_prev, den_prev):
    """One blockwise online-softmax accumulation step, in f32.

    q: [B, Sq, H, D]; k/v: [B, Sk, H, D]; mask: [Sq, Sk] additive.
    Carries: m (running max) [B, H, Sq], num [B, Sq, H, D], den [B, H, Sq].
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * scale + mask[None, None, :, :]
    m_new = torch.maximum(m_prev, s.amax(-1))
    # renormalize the previous accumulator to the new max
    correction = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new[..., None])  # [B, H, Sq, Sk]
    num = num_prev * correction.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v.float()
    )
    den = den_prev * correction + p.sum(-1)
    return m_new, num, den


class RingAttention:
    """Exact ring attention over ``world_size`` ranks (one, in this
    slice). Inputs are ``[B, S, H, D]``; ``__call__`` moves them to
    ``self.device`` (``cuda`` unless ``device="cpu"`` was asked for)."""

    def __init__(self, world_size: int = 1, device=None):
        if world_size != 1:
            raise NotImplementedError(
                "RingAttention over more than one rank needs the "
                "torch.distributed groups of the multi-GPU slice"
            )
        self.num_shards = world_size
        self.device = resolve_device(device)

    def __call__(self, q, k, v, causal: bool = False) -> torch.Tensor:
        """Exact attention over ``[B, S, H, D]`` inputs; the output has
        q's shape and dtype."""
        q, k, v = (torch.as_tensor(x, device=self.device) for x in (q, k, v))
        b, s, h, d = q.shape
        dev = q.device
        m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=dev)
        num = torch.zeros((b, s, h, d), dtype=torch.float32, device=dev)
        den = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
        # one rank: a single hop, in which the kv block held is our own
        if causal:
            pos = torch.arange(s, device=dev)
            mask = torch.where(pos[:, None] >= pos[None, :], 0.0, NEG_INF).float()
        else:
            mask = torch.zeros((s, s), dtype=torch.float32, device=dev)
        _, num, den = _block_attn(q, k, v, mask, m, num, den)
        out = num / den.transpose(1, 2)[..., None]
        return out.to(q.dtype)


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
