#!/usr/bin/env python3
"""Time the attention paths of two checkouts on one CUDA card, in turns.

    python3 scripts/ab_attention.py BEFORE_DIR AFTER_DIR

BEFORE_DIR and AFTER_DIR are roots of two checkouts of this repository
(for example the parent commit unpacked with ``git archive`` into a
directory ``.gitignore`` lists, and the working tree). The turns run
before, after, after, before, each in its own process with its checkout
first on ``sys.path``, so each uses its own ``sparkrdma_tpu_torch`` and
builds its own kernels at first use (outside the timed windows). A turn
times, at the serving path's two full widths (``chip_smoke.py``'s
``ATTN_PATH_SHAPES``, inputs from ``default_rng(21)``):

- ``UlyssesAttention()`` (one shard) calls at bench.py's B4 S2048 H8 D128 bf16
  causal shape and at the transformer workload's B4 S2048 H8 D64 fp32
  shape: host clock around each call, which ends in a device sync;
- the flash training step, ``flash_attention(q, k, v,
  causal=...).float().sum().backward()``, at bench.py's shape (bf16
  causal, the tensor-core kernels) and at the transformer workload's
  (fp32, not causal: the 3xTF32 forward and backward), host clock around
  each step, which ends in a device sync.

Prints the card's name and power limit, one JSON line per turn, and a
last JSON line with each side's median of its two turns' medians.
Needs one CUDA device; exits nonzero without one.
"""

import json
import os
import statistics
import subprocess
import sys
import time

SHAPES = {
    "bench_bf16_causal": (4, 2048, 8, 128, "bfloat16", True),
    "workload_f32": (4, 2048, 8, 64, "float32", False),
}
WARMUP = 3
CALLS = 20
STEPS = 10


def _qkv(torch, dev, shape, seed):
    import numpy as np

    b, s, h, d, dtype, _ = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32))
            .to(getattr(torch, dtype)).to(dev) for _ in range(3)]


def _walls(torch, fn, n):
    out = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def one_turn(root):
    """Time one checkout in this process; print one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from sparkrdma_tpu_torch.ops import UlyssesAttention
    from sparkrdma_tpu_torch.ops import pallas_attention as pa

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"root": root, "module": pa.__file__}
    ul = UlyssesAttention()
    for name, shape in SHAPES.items():
        q, k, v = _qkv(torch, dev, shape, 21)
        call = lambda: ul(q, k, v, causal=shape[5])  # noqa: E731
        _walls(torch, call, WARMUP)
        rec[f"ulysses_{name}_s"] = _walls(torch, call, CALLS)
    for name, tag in (("bench_bf16_causal", "bench"), ("workload_f32", "workload")):
        shape = SHAPES[name]
        q, k, v = (x.requires_grad_(True) for x in _qkv(torch, dev, shape, 31))

        def step(q=q, k=k, v=v, causal=shape[5]):
            for x in (q, k, v):
                x.grad = None
            pa.flash_attention(q, k, v, causal=causal).float().sum().backward()

        _walls(torch, step, WARMUP)
        rec[f"flash_step_{tag}_s"] = _walls(torch, step, STEPS)
    print(json.dumps(rec), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one_turn(sys.argv[2])
        return
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    before, after = sys.argv[1:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    turns = {"before": [], "after": []}
    for side, root in (("before", before), ("after", after),
                       ("after", after), ("before", before)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"{side} turn failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["side"] = side
        print(json.dumps(rec), flush=True)
        turns[side].append(rec)
    keys = [k for k in turns["after"][0] if k.endswith("_s")]
    summary = {side: {k: statistics.median(statistics.median(r[k]) for r in recs)
                      for k in keys}
               for side, recs in turns.items()}
    print(json.dumps({"nvidia_smi": smi, "median_s": summary}), flush=True)


if __name__ == "__main__":
    main()
