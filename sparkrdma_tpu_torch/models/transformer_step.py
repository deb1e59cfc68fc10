"""Transformer train step on one GPU — the training path of the port.

The PyTorch counterpart of the JAX package's ``models/transformer_step.py``:
a one-layer attention + MLP block with an SGD step, for dp = sp = tp = 1.
The JAX package runs the step as one SPMD program over a (dp, sp, tp)
mesh; the mesh here is one device, so the step is plain autograd, and
wider meshes raise ``NotImplementedError`` until the multi-GPU slice.

- ``attn="ring"``: the one-hop dense online softmax of the ring schedule,
  under plain autograd, with no kernel.
- ``attn="ulysses"``: :func:`ulysses_shard_attention`, whose full-sequence
  attention is the flash kernel: ``srt_flash_attn_fwd`` forward, and
  ``srt_flash_attn_bwd_dq`` / ``srt_flash_attn_bwd_dkv`` backward.

Parameters keep the JAX shapes (``[d_in, d_out]``, used as ``x @ w``),
so weights carry across without a transpose (``convert.params_from_jax``).
The MLP's GELU is ``jax.nn.gelu``'s default, the tanh form.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparkrdma_tpu_torch.ops.ring_attention import _block_attn
from sparkrdma_tpu_torch.ops.ulysses_attention import ulysses_shard_attention
from sparkrdma_tpu_torch.utils.torch_compat import resolve_device

NEG_INF = -1e30
PARAM_NAMES = ("wq", "wk", "wv", "wo", "w1", "w2")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` with its default ``approximate=True``: the tanh form
    (the exact erf form differs by about 1e-3)."""
    return F.gelu(x, approximate="tanh")


def _tp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum over the tp group. The group is one rank in this slice, where the
    sum is the identity; the multi-GPU slice all-reduces here."""
    return x


class _TpCopy(torch.autograd.Function):
    """Megatron's "f" operator: identity forward, all-reduce backward.

    The column-parallel matmul consumes a tp-replicated activation; each
    tp shard's backward produces only its slice's contribution to dx, so
    the cotangent must be summed over tp here, or every parameter
    upstream of the MLP receives a partial gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _tp_all_reduce(ct)


class _TpPsum(torch.autograd.Function):
    """Megatron's "g" operator: all-reduce forward, identity backward.

    Conjugate of :class:`_TpCopy`: each tp shard already holds the full
    cotangent of the replicated output, so its adjoint is the identity."""

    @staticmethod
    def forward(ctx, x):
        return _tp_all_reduce(x).view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct


def _tp_copy(x: torch.Tensor) -> torch.Tensor:
    return _TpCopy.apply(x)


def _tp_psum(x: torch.Tensor) -> torch.Tensor:
    return _TpPsum.apply(x)


def init_params(d_model: int, n_heads: int, d_hidden: int, tp: int,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's ``init_params``: the same numpy arrays, byte for
    byte, from the same seed (``n_heads`` and ``tp`` shape nothing)."""
    rng = np.random.default_rng(seed)
    s = 0.02

    def w(*shape):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return {
        "wq": w(d_model, d_model),
        "wk": w(d_model, d_model),
        "wv": w(d_model, d_model),
        "wo": w(d_model, d_model),
        "w1": w(d_model, d_hidden),  # sharded on dim 1 over tp
        "w2": w(d_hidden, d_model),  # sharded on dim 0 over tp
    }


def _ring_attn(q, k, v):
    """The ring schedule over one rank: a single hop in which the kv block
    held is the whole sequence; dense online softmax in f32."""
    b, s, h, dh = q.shape
    dev = q.device
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=dev)
    num = torch.zeros((b, s, h, dh), dtype=torch.float32, device=dev)
    den = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    mask = torch.zeros((s, s), dtype=torch.float32, device=dev)
    _, num, den = _block_attn(q, k, v, mask, m, num, den)
    return (num / den.transpose(1, 2)[..., None]).to(q.dtype)


def _ulysses_attn(q, k, v):
    # seq-gather / head-scatter, full-sequence flash attention, inverse
    # exchange; at one rank both exchanges are the identity
    return ulysses_shard_attention(q, k, v, 1, causal=False)


class TransformerBlock(nn.Module):
    """The block's forward: ``x + attn(x) @ wo``, then the Megatron MLP
    ``x + gelu(x @ w1) @ w2``. Its parameters are the given tensors
    (shared, not copied), in the JAX shapes."""

    def __init__(self, params: Mapping[str, torch.Tensor], n_heads: int,
                 attn: str = "ring"):
        super().__init__()
        for name in PARAM_NAMES:
            self.register_parameter(name, nn.Parameter(params[name].detach()))
        self.n_heads = n_heads
        self.attn = _ring_attn if attn == "ring" else _ulysses_attn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        dh = d // self.n_heads

        def qkv(w):
            return (x @ w).reshape(b, s, self.n_heads, dh)

        att = self.attn(qkv(self.wq), qkv(self.wk), qkv(self.wv))
        x = x + att.reshape(b, s, d) @ self.wo
        # column-parallel w1, row-parallel w2; _tp_copy/_tp_psum are the
        # f/g conjugate pair
        hcol = gelu(_tp_copy(x) @ self.w1)
        return x + _tp_psum(hcol @ self.w2)


class TransformerStep:
    """One-layer attention + MLP block with an SGD train step, on one GPU.

    ``attn`` selects the sequence-parallel schedule, ``"ring"`` (dense,
    plain autograd) or ``"ulysses"`` (the flash kernels forward and
    backward; needs ``n_heads % sp == 0``). ``mesh_shape`` is the JAX
    mesh's ``(dp, sp, tp)``; anything but ``(1, 1, 1)`` waits for the
    multi-GPU slice. Runs on ``cuda`` unless ``device="cpu"`` is asked
    for."""

    def __init__(self, n_heads: int = 4, lr: float = 0.1, attn: str = "ring",
                 device=None, mesh_shape: Tuple[int, int, int] = (1, 1, 1)):
        if attn not in ("ring", "ulysses"):
            raise ValueError(f"unknown attn schedule {attn!r}")
        dp, sp, tp = mesh_shape
        if attn == "ulysses" and n_heads % sp != 0:
            raise ValueError(
                f"ulysses needs n_heads ({n_heads}) divisible by the sp "
                f"axis ({sp})"
            )
        if (dp, sp, tp) != (1, 1, 1):
            raise NotImplementedError(
                f"TransformerStep over a (dp, sp, tp) = {tuple(mesh_shape)} "
                "mesh needs the torch.distributed groups of the multi-GPU "
                "slice"
            )
        self.n_heads = n_heads
        self.lr = lr
        self.attn = attn
        self.device = resolve_device(device)

    def place(self, params, x, y):
        """``(params, x, y)`` as tensors on the step's device."""
        def put(a):
            return torch.as_tensor(a, device=self.device)

        return {k: put(params[k]) for k in PARAM_NAMES}, put(x), put(y)

    def step(self, params, x, y) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(loss, new_params)`` — one SGD step. The loss is the mean
        squared error; as in the JAX step, the sum of squares and its
        gradients are divided by ``x.numel()``, then ``p - lr * g``."""
        params, x, y = self.place(params, x, y)
        block = TransformerBlock(params, self.n_heads, self.attn)
        sq = ((block(x) - y) ** 2).sum()
        names, ps = zip(*block.named_parameters())
        grads = torch.autograd.grad(sq, ps)
        count = float(x.numel())
        with torch.no_grad():
            new = {n: p - self.lr * (g / count)
                   for n, p, g in zip(names, ps, grads)}
        return sq.detach() / count, new

    def run_steps(self, params, x, y, n_steps: int):
        """``(final_loss, new_params)`` after ``n_steps`` SGD steps; the
        loss is the last step's (0 when ``n_steps`` is 0)."""
        params, x, y = self.place(params, x, y)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for _ in range(n_steps):
            loss, params = self.step(params, x, y)
        return loss, params


def reference_step(params, x, y, n_heads: int, lr: float):
    """Single-device implementation of the identical math, with dense
    softmax attention under autograd: the yardstick of the tests. Runs
    on the device of ``x`` (the CPU for numpy inputs)."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    ps = {k: torch.as_tensor(params[k], device=x.device).detach()
          .requires_grad_(True) for k in PARAM_NAMES}
    b, s, d = x.shape
    dh = d // n_heads

    def qkv(w):
        return (x @ w).reshape(b, s, n_heads, dh)

    q, k, v = qkv(ps["wq"]), qkv(ps["wk"]), qkv(ps["wv"])
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(dh)
    att = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)
    h = x + att.reshape(b, s, d) @ ps["wo"]
    out = h + gelu(h @ ps["w1"]) @ ps["w2"]
    loss = ((out - y) ** 2).mean()
    grads = torch.autograd.grad(loss, list(ps.values()))
    with torch.no_grad():
        new = {k: p - lr * g for (k, p), g in zip(ps.items(), grads)}
    return loss.detach(), new
