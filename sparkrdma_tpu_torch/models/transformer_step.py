"""Distributed transformer train step — dp x sp x tp over a ShardMesh.

The PyTorch counterpart of the JAX package's ``models/transformer_step.py``:
a one-layer attention + MLP block with an SGD step, over a ``(dp, sp,
tp)`` mesh (``make_training_mesh``):

- **dp**: the batch split over the ``dp`` axis; gradients summed over it,
- **sp**: the sequence split over the ``sp`` axis, attention by one of
  the two sequence-parallel schedules,
- **tp**: the MLP hidden dimension Megatron-split over the ``tp`` axis;
  activations stay replicated on tp, the second matmul's partial sums
  reduce with one sum over tp.

The JAX package runs the step as one SPMD program (``shard_map``). Here
the shards are rows of one stack on one device (``parallel/mesh.py``):
every shard holds its own copy, as the SPMD program does (``x`` and
``y`` as ``[dp, sp, tp, b / dp, s / sp, d]``, the attention weights
replicated, ``w1`` ``[.., d, H / tp]`` and ``w2`` ``[.., H / tp, d]`` per
tp shard), and each collective is one explicit op on the shard axes:

- ``attn="ring"``: kv blocks hop over sp (``lax.ppermute``), one
  ``srt_neighbor_pull`` launch per hop for k and one for v on CUDA,
  forward and backward (``ops/ring_attention.ring_shard_attention``,
  the dense online softmax in f32);
- ``attn="ulysses"``: the two all-to-alls over sp around one flash
  attention call over every shard (``ops/ulysses_attention``): one flash
  forward, one dq and one dk/dv launch a step (the 3xTF32 kernels for
  the fp32 step with D 64 or 128); needs ``n_heads % sp == 0``;
- ``psum`` over tp in ``_tp_all_reduce`` (under the f/g pair
  ``_TpCopy`` / ``_TpPsum``), and the gradient and loss sums over
  ``(dp, sp)`` in :meth:`TransformerStep._train_shard`.

Parameters keep the JAX shapes (``[d_in, d_out]``, used as ``x @ w``), so
weights carry across without a transpose (``convert.params_from_jax``);
``step`` takes and returns them global. The MLP's GELU is
``jax.nn.gelu``'s default, the tanh form.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparkrdma_tpu_torch.ops.ring_attention import ring_shard_attention
from sparkrdma_tpu_torch.ops.ulysses_attention import ulysses_shard_attention
from sparkrdma_tpu_torch.parallel.mesh import (
    ShardMesh, mesh_or_one_shard, named_mesh, shard, unshard,
)
from sparkrdma_tpu_torch.utils.torch_compat import resolve_device

PARAM_NAMES = ("wq", "wk", "wv", "wo", "w1", "w2")
AXES = ("dp", "sp", "tp")
TP_DIM = 2  # the tp axis among a shard stack's leading dims
# how each tensor splits over the mesh (a JAX PartitionSpec each)
X_SPEC = ("dp", "sp", None)
PARAM_SPECS = {"wq": (), "wk": (), "wv": (), "wo": (),
               "w1": (None, "tp"), "w2": ("tp", None)}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` with its default ``approximate=True``: the tanh form
    (the exact erf form differs by about 1e-3)."""
    return F.gelu(x, approximate="tanh")


def _tp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """``lax.psum`` over the tp axis of a ``[dp, sp, tp, ...]`` stack: the
    sum over tp, broadcast back to every tp shard."""
    return x.sum(dim=TP_DIM, keepdim=True).expand_as(x)


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

    Conjugate of :class:`_TpCopy`. Every tp shard seeds its own (equal)
    loss, so the true adjoint of the sum — a sum of the tp cotangents —
    would scale the w1/w2 gradients by exactly ``tp``; each tp shard
    already holds the full cotangent of the replicated output, so the
    adjoint here is the identity."""

    @staticmethod
    def forward(ctx, x):
        return _tp_all_reduce(x).contiguous()

    @staticmethod
    def backward(ctx, ct):
        return ct


def _tp_copy(x: torch.Tensor) -> torch.Tensor:
    return _TpCopy.apply(x)


def _tp_psum(x: torch.Tensor) -> torch.Tensor:
    return _TpPsum.apply(x)


def make_training_mesh(devices=None) -> ShardMesh:
    """``(dp, sp, tp)`` mesh over the given shards' devices, by the JAX
    package's rule: ``(n // 4, 2, 2)`` for a multiple of 4 (2 x 2 x 2 at
    8), ``(n // 2, 2, 1)`` for another even count, else ``(1, 1, 1)`` on
    the first. The default is one shard on ``cuda``."""
    if devices is None:
        devices = [resolve_device(None)]
    devices = list(devices)
    n = len(devices)
    if n % 4 == 0:
        shape = (n // 4, 2, 2)
    elif n % 2 == 0:
        shape = (n // 2, 2, 1)
    else:
        shape = (1, 1, 1)
        devices = devices[:1]
    return named_mesh(devices[: math.prod(shape)], AXES, shape)


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


def _matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` on every shard: ``a`` ``[*lead, b, s, d_in]``, ``w``
    ``[*lead, d_in, d_out]`` (one batched product over the shards)."""
    *lead, b, s, d_in = a.shape
    return (a.reshape(*lead, b * s, d_in) @ w).reshape(*lead, b, s, w.shape[-1])


def forward_local(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                  n_heads: int, attn: str) -> torch.Tensor:
    """The block on every shard of a ``[dp, sp, tp, b, s, d]`` stack, with
    its parameters stacked ``[dp, sp, tp, d_in, d_out]``: ``x + attn(x) @
    wo``, then the Megatron MLP ``x + gelu(x @ w1) @ w2``."""
    *lead, b, s, d = x.shape
    dh = d // n_heads
    sp = lead[1]

    def qkv(w):
        return _matmul(x, w).reshape(*lead, b, s, n_heads, dh)

    q, k, v = qkv(params["wq"]), qkv(params["wk"]), qkv(params["wv"])
    if attn == "ring":
        att = ring_shard_attention(q, k, v, lead, 1, causal=False)
    else:
        # seq-gather / head-scatter, full-sequence flash attention per
        # head group, inverse exchange
        att = ulysses_shard_attention(q, k, v, 1, sp, causal=False)
    x = x + _matmul(att.reshape(*lead, b, s, d), params["wo"])
    # column-parallel w1, row-parallel w2; _tp_copy/_tp_psum are the f/g
    # conjugate pair
    hcol = gelu(_matmul(_tp_copy(x), params["w1"]))  # [.., b, s, H / tp]
    return x + _tp_psum(_matmul(hcol, params["w2"]))


class TransformerBlock(nn.Module):
    """The block's forward on one shard: ``x`` ``[b, s, d]``. Its
    parameters are the given tensors (shared, not copied), in the JAX
    shapes."""

    def __init__(self, params: Mapping[str, torch.Tensor], n_heads: int,
                 attn: str = "ring"):
        super().__init__()
        for name in PARAM_NAMES:
            self.register_parameter(name, nn.Parameter(params[name].detach()))
        self.n_heads = n_heads
        self.attn = attn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        one = (1, 1, 1)
        params = {n: getattr(self, n).expand(*one, *getattr(self, n).shape)
                  for n in PARAM_NAMES}
        return forward_local(params, x.expand(*one, *x.shape), self.n_heads,
                             self.attn)[0, 0, 0]


class TransformerStep:
    """One-layer attention + MLP block with an SGD train step over a
    ``(dp, sp, tp)`` mesh (``mesh=None``: one shard on ``device``,
    ``cuda`` unless ``device="cpu"`` is asked for).

    ``attn`` selects the sequence-parallel schedule, ``"ring"`` (kv hops
    over sp, dense online softmax) or ``"ulysses"`` (all-to-alls over sp
    around the flash kernels, forward and backward; needs ``n_heads %
    sp == 0``). A CUDA mesh runs the kernels, a CPU mesh their plain
    versions."""

    def __init__(self, mesh: Optional[ShardMesh] = None, n_heads: int = 4,
                 lr: float = 0.1, attn: str = "ring", device=None):
        if attn not in ("ring", "ulysses"):
            raise ValueError(f"unknown attn schedule {attn!r}")
        if mesh is None:
            mesh = make_training_mesh([resolve_device(device)])
        mesh = mesh_or_one_shard(mesh, device)  # a device given must be the mesh's
        if mesh.axis_names != AXES:
            raise ValueError(f"a training mesh has axes {AXES}, not {mesh.axis_names}")
        if attn == "ulysses" and n_heads % mesh.shape["sp"] != 0:
            raise ValueError(
                f"ulysses needs n_heads ({n_heads}) divisible by the sp "
                f"axis ({mesh.shape['sp']})"
            )
        self.mesh = mesh
        self.n_heads = n_heads
        self.lr = lr
        self.attn = attn
        self.device = mesh.device

    def place(self, params, x, y):
        """``(params, x, y)`` as global tensors on the mesh's device."""
        def put(a):
            return torch.as_tensor(a, device=self.device)

        return {k: put(params[k]) for k in PARAM_NAMES}, put(x), put(y)

    def _shard(self, params, x, y):
        """The placed layout: every shard's copy, ``[dp, sp, tp, ...]``."""
        params, x, y = self.place(params, x, y)
        return ({k: shard(self.mesh, params[k], PARAM_SPECS[k]) for k in PARAM_NAMES},
                shard(self.mesh, x, X_SPEC), shard(self.mesh, y, X_SPEC))

    def _unshard(self, params) -> Dict[str, torch.Tensor]:
        return {k: unshard(self.mesh, params[k], PARAM_SPECS[k]) for k in PARAM_NAMES}

    def _grads_shard(self, params, x, y):
        """Every shard's sum of squares ``[dp, sp, tp]`` and the gradients
        of the whole batch's on the placed layout, each shard's copy.

        Autograd is seeded with the sum of every shard's LOCAL sum of
        squares, so each shard seeds its own loss with 1, as each shard
        of the JAX program differentiates its own; the gradients then
        sum over dp and sp only (tp-split weights keep their slice, and
        the tp shards of a replicated weight computed equal gradients)."""
        ps = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        out = forward_local(ps, x, self.n_heads, self.attn)
        sq = ((out - y) ** 2).sum(dim=(-3, -2, -1))  # [dp, sp, tp]
        grads = torch.autograd.grad(sq.sum(), list(ps.values()))
        return sq.detach(), {k: g.sum(dim=(0, 1), keepdim=True).expand_as(g)
                             for k, g in zip(ps, grads)}

    def _train_shard(self, params, x, y):
        """One SGD step on the placed layout: ``(loss, new placed params)``;
        the gradients divide by the global element count, as the loss
        does."""
        dp, sp, _ = self.mesh.axis_sizes
        sq, grads = self._grads_shard(params, x, y)
        gcount = float(x[0, 0, 0].numel() * dp * sp)
        loss = sq[:, :, 0].sum() / gcount
        new = {k: p - self.lr * (grads[k] / gcount) for k, p in params.items()}
        return loss, new

    def gradients(self, params, x, y) -> Dict[str, torch.Tensor]:
        """The gradients of the whole batch's sum of squares, global
        shapes in, every shard's copy out (``[dp, sp, tp, ...]``, as
        :func:`shard` lays out the parameters): what a step scales by
        ``lr / x.numel()``."""
        return self._grads_shard(*self._shard(params, x, y))[1]

    def step(self, params, x, y) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(loss, new_params)`` — one SGD step, global shapes in and out.
        The loss is the mean squared error: the sum of squares over every
        (dp, sp) shard over ``x.numel()``; each gradient the same way,
        then ``p - lr * g``."""
        params, x, y = self._shard(params, x, y)
        loss, new = self._train_shard(params, x, y)
        return loss, self._unshard(new)

    def run_steps(self, params, x, y, n_steps: int):
        """``(final_loss, new_params)`` after ``n_steps`` SGD steps, in the
        placed layout between steps; the loss is the last step's (0 when
        ``n_steps`` is 0)."""
        params, x, y = self._shard(params, x, y)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for _ in range(n_steps):
            loss, params = self._train_shard(params, x, y)
        return loss, self._unshard(params)


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
