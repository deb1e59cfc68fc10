"""Flash attention — the attention hot op on one device, forward and
backward.

The PyTorch counterpart of the JAX package's ``ops/pallas_attention.py``:
exact attention over ``[B, S, H, D]`` inputs by online softmax over kv
blocks, so the ``[S, S]`` score matrix never exists in device memory,
and its FlashAttention-2 backward, which re-materialises the
probability tiles from ``(q, k, lse)``.

- ``flash_attention`` / ``flash_attention_fwd``: on CUDA tensors one
  launch of a hand-written forward kernel on the current stream, not
  waited on; on CPU tensors :func:`flash_attention_reference`, the plain
  version. The kernel is picked before the launch by :func:`fwd_entry`,
  a pure function of dtype, precision, head dim and alignment: bf16 at
  precision ``"default"`` with D 64 or 128 and 16-byte-aligned
  q/k/v/out takes the tensor-core kernel of
  ``csrc/flash_attn_fwd_sm90.cu`` (``srt_flash_attn_fwd_sm90``: wgmma +
  TMA), everything else the kernel of ``csrc/flash_attn_fwd.cu``
  (``srt_flash_attn_fwd``: f32 FMA). A kernel that does not build or
  launch raises; nothing retries on the other kernel or falls back.
- ``flash_attention_bwd``: on CUDA tensors one dq launch and one dk/dv
  launch, of the pair :func:`bwd_entry` names the same way: the
  tensor-core ``srt_flash_attn_bwd_dq_sm90`` and
  ``srt_flash_attn_bwd_dkv_sm90`` (``csrc/flash_attn_bwd_sm90.cu``) or
  the SIMT ``srt_flash_attn_bwd_dq`` and ``srt_flash_attn_bwd_dkv``
  (``csrc/flash_attn_bwd.cu``); on CPU tensors
  :func:`flash_attention_bwd_reference`.
- ``flash_attention`` is differentiable: with grad mode on and an input
  that requires grad it runs :class:`_FlashAttention`, the counterpart of
  the JAX ``custom_vjp`` (the forward with lse, then the two backward
  kernels). Inference keeps the forward without lse.
- Inputs are float32, bfloat16 or float16. ``precision`` takes None,
  ``"default"``, ``"high"`` or ``"highest"``; None picks as JAX does:
  ``"highest"`` for float32, ``"default"`` otherwise. bf16 at
  ``"default"`` takes the tensor-core kernels (where D and alignment
  allow), which compute as the JAX kernels do at the bf16
  ``precision=DEFAULT`` (one bf16 MXU pass a product): products from
  bf16 operands into f32, ``p`` rounded to bf16 before p.v (and p^T.do),
  ``ds`` rounded to bf16 before ds.k and ds^T.q, ``l`` and ``ds`` from
  the f32 ``p``. Every other input takes the SIMT kernels, which widen
  to f32 and compute full-f32 products: float32 at every precision,
  float16, and bf16 at ``"high"`` or ``"highest"``. Outputs are rounded
  back to the input dtype (to nearest even).
- CPU tensors run the plain versions in f32 whatever the precision. The
  JAX ``interpret=`` argument has no counterpart: the plain version is
  the port's interpret mode.

Every launch adds one to its kernel's counter: ``flash_fwd_launches``
(every forward launch, on either kernel), ``flash_fwd_sm90_launches``
(those of ``srt_flash_attn_fwd_sm90``), ``flash_bwd_dq_launches`` and
``flash_bwd_dkv_launches`` (every backward launch, on either pair),
``flash_bwd_dq_sm90_launches`` and ``flash_bwd_dkv_sm90_launches``
(those of the tensor-core pair).
"""

from __future__ import annotations

import math
import numbers
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # the largest D the CUDA kernels take
SM90_HEAD_DIMS = (64, 128)  # the head dims the tensor-core kernels take
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
PRECISIONS = ("default", "high", "highest")

flash_fwd_launches = 0
flash_fwd_sm90_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
flash_bwd_dq_sm90_launches = 0
flash_bwd_dkv_sm90_launches = 0


def reset_launch_counts() -> None:
    global flash_fwd_launches, flash_fwd_sm90_launches
    global flash_bwd_dq_launches, flash_bwd_dkv_launches
    global flash_bwd_dq_sm90_launches, flash_bwd_dkv_sm90_launches
    flash_fwd_launches = 0
    flash_fwd_sm90_launches = 0
    flash_bwd_dq_launches = 0
    flash_bwd_dkv_launches = 0
    flash_bwd_dq_sm90_launches = 0
    flash_bwd_dkv_sm90_launches = 0


def resolve_precision(precision, dtype: torch.dtype) -> str:
    """``precision`` as one of :data:`PRECISIONS`: None picks as the JAX
    ``flash_attention`` does, ``"highest"`` for float32 and ``"default"``
    otherwise. Raises ``ValueError`` for anything else."""
    if precision is None:
        return "highest" if dtype == torch.float32 else "default"
    if not isinstance(precision, str) or precision not in PRECISIONS:
        raise ValueError(
            f"precision must be None or one of {PRECISIONS}, got {precision!r}"
        )
    return precision


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
            f"q, k and v must all be float32, bfloat16 or float16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(
            f"q, k and v lie on different devices: {q.device}, {k.device}, "
            f"{v.device}"
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


def _pad_rows(x: torch.Tensor, s_pad: int, value: float) -> torch.Tensor:
    """[B, H, S] -> [B, H, s_pad], the new rows set to ``value``."""
    return torch.nn.functional.pad(x, (0, s_pad - x.shape[-1]), value=value)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool = False,
    block_q: int = 512, block_k: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: the JAX ``_bwd_impl`` in torch, in f32.

    ``delta = rowsum(do * out)``; then ``p = exp(s * scale - lse)`` is
    re-materialised tile by tile with the masks and causal skips of
    ``_dq_kernel`` (a kv-minor sweep per q block) and ``_dkv_kernel`` (a
    q-minor sweep per kv block, from the first live q block). ``lse`` is
    ``[B, H, S]`` f32; padded rows take the forward's ``+1e30`` pin, so
    their ``p`` is 0. Returns ``(dq, dk, dv)`` in the input dtype."""
    return _bwd_reference(q, k, v, out, lse, do, causal, block_q, block_k)


def flash_attention_bwd_sm90_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool = False,
    block_q: int = 512, block_k: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The function of the tensor-core backward pair
    (``srt_flash_attn_bwd_dq_sm90``, ``srt_flash_attn_bwd_dkv_sm90``):
    :func:`flash_attention_bwd_reference`'s blocking and masks, with the
    JAX kernels' bf16 ``precision=DEFAULT`` roundings: ``p`` rounded to
    bf16 before ``p^T do``, ``ds`` (formed from the f32 ``p``) rounded to
    bf16 before ``ds k`` and ``ds^T q``, to nearest even. For bf16 inputs,
    whose other operands are bf16 already. Used by the tests and by
    ``chip_smoke.py`` to hold the kernels to their own arithmetic; nothing
    on the main path calls it."""
    return _bwd_reference(q, k, v, out, lse, do, causal, block_q, block_k,
                          round_bf16=True)


def _bwd_reference(q, k, v, out, lse, do, causal, block_q, block_k,
                   sweeps=("dq", "dkv"), round_bf16=False):
    """:func:`flash_attention_bwd_reference` (or, with ``round_bf16``,
    :func:`flash_attention_bwd_sm90_reference`), running only the named
    sweeps (the others' gradients stay zero), so each sweep can be timed
    beside its kernel."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    bq, bk, s_pad = _resolve_blocks(s, block_q, block_k)

    def prep(x):  # [B, S, H, D] -> [B, H, s_pad, D] f32
        x = x.permute(0, 2, 1, 3).float()
        return torch.nn.functional.pad(x, (0, 0, 0, s_pad - s))

    qt, kt, vt, dot = prep(q), prep(k), prep(v), prep(do)
    delta = _pad_rows(torch.einsum("bshd,bshd->bhs", do.float(), out.float()),
                      s_pad, 0.0)
    lse = _pad_rows(lse.float(), s_pad, -NEG_INF)
    dev = q.device
    pos = torch.arange(s_pad, device=dev)

    def probs(iq, ik):
        """p [B, H, bq, bk] and ds of the (iq, ik) tile pair."""
        qp, kp = pos[iq * bq:(iq + 1) * bq], pos[ik * bk:(ik + 1) * bk]
        qb, dob = qt[:, :, iq * bq:(iq + 1) * bq], dot[:, :, iq * bq:(iq + 1) * bq]
        kb, vb = kt[:, :, ik * bk:(ik + 1) * bk], vt[:, :, ik * bk:(ik + 1) * bk]
        sc = torch.matmul(qb, kb.transpose(-1, -2)) * scale
        mask = (qp[:, None] < s) & (kp[None, :] < s)
        if causal:
            mask = mask & (qp[:, None] >= kp[None, :])
        sc = torch.where(mask, sc, NEG_INF)
        p = torch.exp(sc - lse[:, :, iq * bq:(iq + 1) * bq, None])
        dp = torch.matmul(dob, vb.transpose(-1, -2))
        ds = p * (dp - delta[:, :, iq * bq:(iq + 1) * bq, None])
        return p, ds, qb, dob, kb

    def live(iq, ik):  # the kernels' causal block skip
        return not causal or ik * bk <= iq * bq + bq - 1

    def rnd(x):  # a product's bf16 operand, rounded to nearest even
        return x.bfloat16().float() if round_bf16 else x

    dq = torch.zeros((b, h, s_pad, d), dtype=torch.float32, device=dev)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for iq in range(s_pad // bq if "dq" in sweeps else 0):
        for ik in range(s_pad // bk):  # _dq_kernel: kv blocks minor
            if not live(iq, ik):
                break
            _, ds, _, _, kb = probs(iq, ik)
            dq[:, :, iq * bq:(iq + 1) * bq] += torch.matmul(rnd(ds), kb) * scale
    for ik in range(s_pad // bk if "dkv" in sweeps else 0):
        for iq in range(s_pad // bq):  # _dkv_kernel: q blocks minor
            if not live(iq, ik):
                continue
            p, ds, qb, dob, _ = probs(iq, ik)
            dv[:, :, ik * bk:(ik + 1) * bk] += torch.matmul(
                rnd(p).transpose(-1, -2), dob)
            dk[:, :, ik * bk:(ik + 1) * bk] += (
                torch.matmul(rnd(ds).transpose(-1, -2), qb) * scale)

    def unprep(x, like):
        return x[:, :, :s].permute(0, 2, 1, 3).to(like.dtype)

    return unprep(dq, q), unprep(dk, k), unprep(dv, v)


def _kernel_path(q: torch.Tensor) -> bool:
    """Attention runs the kernel iff its inputs lie on CUDA."""
    return q.device.type == "cuda"


def _sm90_route(q: torch.Tensor, precision, tensors) -> bool:
    """Whether the tensor-core kernels take these inputs: bf16 at
    precision ``"default"`` with D in :data:`SM90_HEAD_DIMS` and every
    tensor on a 16-byte boundary (their TMA loads and 16-byte stores need
    it)."""
    return (q.dtype == torch.bfloat16
            and resolve_precision(precision, q.dtype) == "default"
            and q.shape[-1] in SM90_HEAD_DIMS
            and all(x.data_ptr() % 16 == 0 for x in tensors))


def fwd_entry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, precision=None) -> str:
    """The C entry point a CUDA forward launches: the tensor-core
    ``srt_flash_attn_fwd_sm90`` for bf16 at precision ``"default"`` with
    D in :data:`SM90_HEAD_DIMS` and q, k, v and out on 16-byte boundaries,
    else ``srt_flash_attn_fwd``."""
    if _sm90_route(q, precision, (q, k, v, out)):
        return "srt_flash_attn_fwd_sm90"
    return "srt_flash_attn_fwd"


def bwd_entry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
              dv: torch.Tensor, precision=None) -> Tuple[str, str]:
    """The C entry points ``(dq, dk/dv)`` a CUDA backward launches: the
    tensor-core pair ``srt_flash_attn_bwd_dq_sm90`` and
    ``srt_flash_attn_bwd_dkv_sm90`` for bf16 at precision ``"default"``
    with D in :data:`SM90_HEAD_DIMS` and q, k, v, do, dq, dk and dv on
    16-byte boundaries, else ``srt_flash_attn_bwd_dq`` and
    ``srt_flash_attn_bwd_dkv``. A pure function of dtype, precision, D
    and alignment, as :func:`fwd_entry` is."""
    if _sm90_route(q, precision, (q, k, v, do, dq, dk, dv)):
        return "srt_flash_attn_bwd_dq_sm90", "srt_flash_attn_bwd_dkv_sm90"
    return "srt_flash_attn_bwd_dq", "srt_flash_attn_bwd_dkv"


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            want_lse: bool, precision=None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    from sparkrdma_tpu_torch.ops import _build

    global flash_fwd_launches, flash_fwd_sm90_launches
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
    name = fwd_entry(q, k, v, out, precision)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, s, h, d, _DTYPE_CODE[q.dtype], int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: "
            f"{lib.srt_error_string(rc).decode()} ({rc})"
        )
    flash_fwd_launches += 1
    if name == "srt_flash_attn_fwd_sm90":
        flash_fwd_sm90_launches += 1
    return out, lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
    block_q: int = 512, block_k: int = 512, want_lse: bool = False,
    precision=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Exact attention over ``[B, S, H, D]`` float32, bfloat16 or float16
    inputs. Returns ``(out [B, S, H, D] in the input dtype, lse [B, H, S]
    f32 or None)``; ``lse[b, h, s]`` is the row's logsumexp of the
    scaled, masked scores.

    CUDA tensors: one launch (D <= 256) of the kernel :func:`fwd_entry`
    names from the dtype, ``precision`` (see :func:`resolve_precision`),
    D and alignment. The kernel picks its own tiles; ``block_q``/``block_k``
    are validated and set only the plain version's blocking. A strided
    (non-contiguous) input is copied with ``.contiguous()`` first. CPU
    tensors: the plain version :func:`flash_attention_reference`, in f32
    at every precision (there is no ``interpret=``: the plain version is
    the port's interpret mode)."""
    _check(q, k, v, block_q, block_k)
    resolve_precision(precision, q.dtype)
    if _kernel_path(q):
        q, k, v = (x.contiguous() for x in (q, k, v))
        return _launch(q, k, v, causal, want_lse, precision)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return flash_attention_reference(q, k, v, causal, block_q, block_k,
                                     want_lse)


def _launch_bwd(q, k, v, out, lse, do, causal, precision=None):
    from sparkrdma_tpu_torch.ops import _build

    global flash_bwd_dq_launches, flash_bwd_dkv_launches
    global flash_bwd_dq_sm90_launches, flash_bwd_dkv_sm90_launches
    b, s, h, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(
            f"head dim {d} exceeds the kernel's maximum of {MAX_HEAD_DIM}"
        )
    lib = _build.load()
    dq, dk, dv = (torch.empty_like(x, memory_format=torch.contiguous_format)
                  for x in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    # delta = rowsum(do * out) [B, H, S] f32, a plain torch op as the JAX
    # package leaves it to XLA; from `out` in the input dtype, as saved
    delta = torch.einsum("bshd,bshd->bhs", do.float(), out.float()).contiguous()
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    sizes = (b, s, h, d, _DTYPE_CODE[q.dtype], int(bool(causal)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream

        def call(name, *outs):
            rc = getattr(lib, name)(*ins, *(x.data_ptr() for x in outs),
                                    *sizes, stream)
            if rc != 0:
                raise RuntimeError(
                    f"{name} launch failed: "
                    f"{lib.srt_error_string(rc).decode()} ({rc})"
                )

        dq_name, dkv_name = bwd_entry(q, k, v, do, dq, dk, dv, precision)
        call(dq_name, dq)
        flash_bwd_dq_launches += 1
        flash_bwd_dq_sm90_launches += int(dq_name.endswith("_sm90"))
        call(dkv_name, dk, dv)
        flash_bwd_dkv_launches += 1
        flash_bwd_dkv_sm90_launches += int(dkv_name.endswith("_sm90"))
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool = False,
    block_q: int = 512, block_k: int = 512, precision=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of flash attention, in the input dtype,
    from the forward's inputs, its output ``out`` (input dtype) and
    ``lse`` (``[B, H, S]`` f32), and the output's cotangent ``do``.

    CUDA tensors: one dq and one dk/dv launch on the current stream (D <=
    256), of the pair :func:`bwd_entry` names; strided inputs are copied
    with ``.contiguous()`` first. A launch that fails raises with the
    kernel's name; nothing retries on the other pair. CPU tensors: the
    plain version :func:`flash_attention_bwd_reference`, in f32 at every
    precision."""
    _check(q, k, v, block_q, block_k)
    resolve_precision(precision, q.dtype)
    for name, x in (("out", out), ("do", do)):
        if not isinstance(x, torch.Tensor) or x.shape != q.shape \
                or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} must be a {q.dtype} tensor of q's shape "
                f"{tuple(q.shape)} on {q.device}"
            )
    b, s, h, _ = q.shape
    if (not isinstance(lse, torch.Tensor) or lse.shape != (b, h, s)
            or lse.dtype != torch.float32 or lse.device != q.device):
        raise ValueError(f"lse must be a float32 [B, H, S] = {(b, h, s)} "
                         f"tensor on {q.device}")
    if _kernel_path(q):
        return _launch_bwd(*(x.contiguous() for x in (q, k, v, out, lse, do)),
                           causal, precision)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                         block_q, block_k)


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX ``_flash`` custom VJP: the forward with
    its lse, saving ``(q, k, v, out, lse)`` with ``out`` in the input
    dtype as JAX saves it (bf16 ``delta`` comes from the rounded output),
    and a backward through :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, precision):
        out, lse = flash_attention_fwd(q, k, v, causal, block_q, block_k,
                                       want_lse=True, precision=precision)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocking = (causal, block_q, block_k, precision)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         *ctx.blocking)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: int = 512,
                    block_k: int = 512, precision=None) -> torch.Tensor:
    """Exact attention over ``[B, S, H, D]`` inputs; the output has the
    input's shape and dtype. See :func:`flash_attention_fwd`, and
    :func:`resolve_precision` for ``precision``. Differentiable: with
    grad mode on and an input that requires grad, the backward runs
    :func:`flash_attention_bwd` at the same precision."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, block_q, block_k,
                                     precision)
    return flash_attention_fwd(q, k, v, causal, block_q, block_k,
                               precision=precision)[0]
