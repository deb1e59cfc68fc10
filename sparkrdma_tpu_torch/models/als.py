"""Device-resident ALS matrix factorization — the iterative wide shuffle.

The PyTorch counterpart of the JAX package's ``models/als.py`` (MLlib
ALS on MovieLens-20M). Users and items are block-sharded over the mesh;
ratings are bucketed into padded per-row lists ``[rows, cap]`` of (col,
rating), -1 / 0 padded. Each half-iteration gathers the other side's
factors on every shard (the tiled all-gather), then solves every row's
normal equations ``(F^T F + reg * max(n, 1) * I) x = F^T r`` as one
batched ``torch.linalg.solve``: dense ops, as in the JAX package (XLA
ops there, not Pallas kernels).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.ops.sort import pack_by_partition
from sparkrdma_tpu_torch.parallel.mesh import ShardMesh, mesh_or_one_shard


def _pad_rows(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
              n_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded per-row lists ``(idx [n_rows, cap] int32, -1 padded; val
    float32, 0 padded)``, each row's entries in input order, ``cap`` the
    longest row (at least 1): the JAX package's lists by one stable sort."""
    cap = max(1, int(torch.bincount(row, minlength=n_rows).max()))
    idx, _, _ = pack_by_partition(col.to(torch.int32), row, n_rows, cap, fill=-1)
    vals, _, _ = pack_by_partition(val, row, n_rows, cap, fill=0)
    return idx, vals


class ALS:
    """Alternating least squares over a mesh of E shards. ``mesh``
    defaults to one shard on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for)."""

    def __init__(self, mesh: Optional[ShardMesh] = None, rank: int = 8,
                 reg: float = 0.1, device=None):
        self.mesh = mesh_or_one_shard(mesh, device)
        self.device = self.mesh.device
        self.num_shards = self.mesh.num_shards
        self.rank = rank
        self.reg = reg
        self._cache = {}
        # walls of the last ``fit``: ratings to the device and the padded
        # lists; the iterations (ending in the factors' readback)
        self.last_walls: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def lists(self, ratings: torch.Tensor, n_users: int, n_items: int):
        """:meth:`prepare` on the mesh's device: ``ratings`` is an ``[m,
        3]`` tensor there. Returns tensors."""
        e = self.num_shards
        nu = int(math.ceil(n_users / e))
        ni = int(math.ceil(n_items / e))
        # int() of a float rating row truncates, as torch's cast does
        users = ratings[:, 0].to(torch.int64)
        items = ratings[:, 1].to(torch.int64)
        vals = ratings[:, 2].to(torch.float32)
        u_idx, u_val = _pad_rows(users, items, vals, e * nu)
        i_idx, i_val = _pad_rows(items, users, vals, e * ni)
        return u_idx, u_val, i_idx, i_val, nu, ni

    def prepare(self, ratings: np.ndarray, n_users: int, n_items: int):
        """ratings: [m, 3] (user, item, rating). Returns numpy padded
        per-user and per-item lists ``(u_idx, u_val, i_idx, i_val, nu,
        ni)``, byte-identical to the JAX package's; the bucketing runs on
        the mesh's device."""
        out = self.lists(self._upload(ratings), n_users, n_items)
        return tuple(x.cpu().numpy() for x in out[:4]) + out[4:]

    def _upload(self, ratings: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(ratings)).to(self.device)

    # ------------------------------------------------------------------
    def _build(self, nu, ni, cap_u, cap_i, iters):
        e = self.num_shards
        k = self.rank
        reg = self.reg

        def solve_side(own_idx, own_val, other_all):
            # own_idx/val: [rows, cap]; other_all: [N_other, k]
            valid = (own_idx >= 0).to(torch.float32)
            f = other_all[own_idx.clamp(min=0).to(torch.int64)] * valid[..., None]
            ft = f.transpose(1, 2)
            eye = torch.eye(k, dtype=torch.float32, device=f.device)
            a = ft @ f + reg * valid.sum(dim=1).clamp(min=1.0)[:, None, None] * eye
            b = ft @ (own_val * valid)[..., None]
            del f, ft
            return torch.linalg.solve(a, b).squeeze(-1)

        def fn(u_idx, u_val, i_idx, i_val, u0, v0):
            if u0.shape != (e * nu, k) or v0.shape != (e * ni, k):
                raise ValueError(
                    f"step built for [{e * nu}, {k}] and [{e * ni}, {k}] "
                    f"factors, got {list(u0.shape)}, {list(v0.shape)}")
            u, v = u0, v0
            for _ in range(iters):
                # the wide shuffle: every shard needs the other side's
                # factors. The tiled all-gather of co-resident shards is
                # the flat [E * n, k] stack itself: each shard reads it in
                # place, no bytes move
                u = solve_side(u_idx, u_val, v)
                v = solve_side(i_idx, i_val, u)
            return u, v

        return fn

    def step(self, nu: int, ni: int, cap_u: int, cap_i: int, iters: int) -> Callable:
        """The cached alternating loop ``fn(u_idx, u_val, i_idx, i_val,
        u0, v0) -> (u, v)`` (``iters`` iterations) over stacks on the
        mesh's device."""
        key = (nu, ni, cap_u, cap_i, iters)
        fn = self._cache.get(key)
        if fn is None:
            fn = self._build(nu, ni, cap_u, cap_i, iters)
            self._cache[key] = fn
        return fn

    def initial(self, nu: int, ni: int, seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray]:
        """The start factors ``(u0 [E * nu, rank], v0 [E * ni, rank])``
        float32, drawn as the JAX package draws them."""
        e = self.num_shards
        rng = np.random.default_rng(seed)
        u0 = (rng.normal(size=(e * nu, self.rank)) * 0.1).astype(np.float32)
        v0 = (rng.normal(size=(e * ni, self.rank)) * 0.1).astype(np.float32)
        return u0, v0

    # ------------------------------------------------------------------
    def fit(
        self, ratings: np.ndarray, n_users: int, n_items: int, iters: int = 10,
        seed: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        t0 = time.perf_counter()
        u_idx, u_val, i_idx, i_val, nu, ni = self.lists(
            self._upload(ratings), n_users, n_items)
        t1 = time.perf_counter()
        fn = self.step(nu, ni, u_idx.shape[1], i_idx.shape[1], iters)
        u0, v0 = (torch.from_numpy(x).to(self.device)
                  for x in self.initial(nu, ni, seed))
        u, v = fn(u_idx, u_val, i_idx, i_val, u0, v0)
        out = u[:n_users].cpu().numpy(), v[:n_items].cpu().numpy()
        self.last_walls = {"prepare_s": t1 - t0, "fit_s": time.perf_counter() - t1}
        return out


def rmse(u: np.ndarray, v: np.ndarray, ratings: np.ndarray) -> float:
    pred = (u[ratings[:, 0].astype(int)] * v[ratings[:, 1].astype(int)]).sum(axis=1)
    return float(np.sqrt(np.mean((pred - ratings[:, 2]) ** 2)))


def reference_als(
    ratings: np.ndarray, n_users: int, n_items: int, rank=8, reg=0.1,
    iters=10, seed=0, u0: Optional[np.ndarray] = None,
    v0: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense numpy ALS (same math, fp64) for correctness checks."""
    rng = np.random.default_rng(seed)
    u = u0.copy() if u0 is not None else rng.normal(size=(n_users, rank)) * 0.1
    v = v0.copy() if v0 is not None else rng.normal(size=(n_items, rank)) * 0.1
    by_user = [[] for _ in range(n_users)]
    by_item = [[] for _ in range(n_items)]
    for a, b, r in ratings:
        by_user[int(a)].append((int(b), r))
        by_item[int(b)].append((int(a), r))

    def solve(rows, other):
        out = np.zeros((len(rows), rank))
        for i, lst in enumerate(rows):
            if not lst:
                continue
            idx = np.array([x[0] for x in lst])
            val = np.array([x[1] for x in lst])
            f = other[idx]
            a = f.T @ f + reg * len(lst) * np.eye(rank)
            out[i] = np.linalg.solve(a, f.T @ val)
        return out

    for _ in range(iters):
        u = solve(by_user, v)
        v = solve(by_item, u)
    return u.astype(np.float32), v.astype(np.float32)
