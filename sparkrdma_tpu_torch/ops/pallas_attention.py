"""Flash attention forward — the attention hot op on one device.

The PyTorch counterpart of the JAX package's ``ops/pallas_attention.py``
forward: exact attention over ``[B, S, H, D]`` inputs by online softmax
over kv blocks, so the ``[S, S]`` score matrix never exists in device
memory.

- ``flash_attention`` / ``flash_attention_fwd``: on CUDA tensors one
  launch of the hand-written kernel of ``csrc/flash_attn_fwd.cu``
  (``srt_flash_attn_fwd``) on the current stream, not waited on; on CPU
  tensors :func:`flash_attention_reference`, the plain version. A kernel
  that does not build or launch raises; nothing falls back.
- fp32 inputs are computed in full fp32 (the JAX ``HIGHEST``); bf16
  inputs are widened to f32 inside, as the JAX kernel body does, and the
  output is rounded back to the input dtype.
- Gradients are the training slice's work: with grad mode on, inputs
  that require grad raise ``NotImplementedError``.

Every launch adds one to ``flash_fwd_launches``.
"""

from __future__ import annotations

import math
import numbers
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # the largest D the CUDA kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

flash_fwd_launches = 0


def reset_launch_counts() -> None:
    global flash_fwd_launches
    flash_fwd_launches = 0


def _resolve_blocks(s: int, block_q: int, block_k: int):
    """Clamp blocks for short sequences to the next power of two <= s
    (>= 8), and pad the sequence to a multiple of both blocks so every
    kv block is visited (the JAX package's blocking, kept so the plain
    version sums in the same blocks)."""
    if s < block_q:
        block_q = max(8, 1 << (s.bit_length() - 1))
    if s < block_k:
        block_k = max(8, 1 << (s.bit_length() - 1))
    lcm = math.lcm(block_q, block_k)
    s_pad = int(math.ceil(s / lcm)) * lcm
    return block_q, block_k, s_pad


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           block_q: int, block_k: int) -> None:
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if (isinstance(blk, bool) or not isinstance(blk, numbers.Integral)
                or blk < 1):
            raise ValueError(f"{name} must be a positive int, got {blk!r}")
    if not all(isinstance(x, torch.Tensor) for x in (q, k, v)):
        raise TypeError("q, k and v must be torch tensors")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D], got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k and v differ in shape: {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k and v must all be float32 or bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(
            f"q, k and v lie on different devices: {q.device}, {k.device}, "
            f"{v.device}"
        )
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash attention has no backward yet: the dq/dkv kernels come "
            "with the training slice; call it under torch.no_grad()"
        )


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
    block_q: int = 512, block_k: int = 512, want_lse: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version: the JAX ``_kernel``'s blockwise online softmax,
    batched over ``(B, H)`` with one ``torch.matmul`` per ``(block_q,
    block_k)`` tile, in f32, with the same causal block skip and the same
    masking. Returns ``(out [B, S, H, D] in q's dtype, lse [B, H, S] f32
    or None)``. On a CUDA device its f32 products are full f32 only while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (the default)."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    bq, bk, s_pad = _resolve_blocks(s, block_q, block_k)

    def prep(x):  # [B, S, H, D] -> [B, H, s_pad, D] f32
        x = x.permute(0, 2, 1, 3).float()
        return torch.nn.functional.pad(x, (0, 0, 0, s_pad - s))

    qt, kt, vt = prep(q), prep(k), prep(v)
    dev = q.device
    out = torch.empty((b, h, s_pad, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, s_pad), dtype=torch.float32, device=dev)
    for iq in range(s_pad // bq):
        qb = qt[:, :, iq * bq:(iq + 1) * bq]
        q_pos = iq * bq + torch.arange(bq, device=dev)[:, None]
        m = torch.full((b, h, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, bq, d), dtype=torch.float32, device=dev)
        for ik in range(s_pad // bk):
            if causal and ik * bk > iq * bq + bq - 1:
                break  # above the diagonal band: the kernel's block skip
            kb = kt[:, :, ik * bk:(ik + 1) * bk]
            vb = vt[:, :, ik * bk:(ik + 1) * bk]
            sc = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            kv_pos = ik * bk + torch.arange(bk, device=dev)[None, :]
            mask = kv_pos < s
            if causal:
                mask = mask & (q_pos >= kv_pos)
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.matmul(p, vb)
            m = m_new
        denom = torch.where(l > 0, l, 1.0)
        out[:, :, iq * bq:(iq + 1) * bq] = acc / denom[..., None]
        lse[:, :, iq * bq:(iq + 1) * bq] = torch.where(
            l > 0, m + torch.log(denom), -NEG_INF
        )
    out = out[:, :, :s].permute(0, 2, 1, 3).to(q.dtype)
    return out, (lse[:, :, :s].contiguous() if want_lse else None)


def _kernel_path(q: torch.Tensor) -> bool:
    """Attention runs the kernel iff its inputs lie on CUDA."""
    return q.device.type == "cuda"


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            want_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    from sparkrdma_tpu_torch.ops import _build

    global flash_fwd_launches
    b, s, h, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(
            f"head dim {d} exceeds the kernel's maximum of {MAX_HEAD_DIM}"
        )
    lib = _build.load()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if q.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.srt_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, s, h, d, _DTYPE_CODE[q.dtype], int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"srt_flash_attn_fwd launch failed: "
            f"{lib.srt_error_string(rc).decode()} ({rc})"
        )
    flash_fwd_launches += 1
    return out, lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
    block_q: int = 512, block_k: int = 512, want_lse: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Exact attention over ``[B, S, H, D]`` float32 or bfloat16 inputs.
    Returns ``(out [B, S, H, D] in the input dtype, lse [B, H, S] f32 or
    None)``; ``lse[b, h, s]`` is the row's logsumexp of the scaled,
    masked scores.

    CUDA tensors: one ``srt_flash_attn_fwd`` launch (D <= 256). The
    kernel picks its own tiles; ``block_q``/``block_k`` are validated and
    set only the plain version's blocking. A strided (non-contiguous)
    input is copied with ``.contiguous()`` first. CPU tensors: the plain
    version :func:`flash_attention_reference`."""
    _check(q, k, v, block_q, block_k)
    if _kernel_path(q):
        q, k, v = (x.contiguous() for x in (q, k, v))
        return _launch(q, k, v, causal, want_lse)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return flash_attention_reference(q, k, v, causal, block_q, block_k,
                                     want_lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """Exact attention over ``[B, S, H, D]`` inputs; the output has the
    input's shape and dtype. See :func:`flash_attention_fwd`."""
    return flash_attention_fwd(q, k, v, causal, block_q, block_k)[0]
