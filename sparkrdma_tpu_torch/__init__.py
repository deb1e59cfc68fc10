"""sparkrdma_tpu_torch — the shuffle framework's port to PyTorch and CUDA.

A second package beside the JAX package ``sparkrdma_tpu``, written for
an NVIDIA H100: plain tensor code is PyTorch, and every Pallas kernel of
the JAX package becomes a kernel written by hand for Hopper
(``ops/csrc``). Module paths mirror the JAX package's, so each
counterpart sits under the same relative path. The package imports
neither jax nor the JAX package: it keeps its own copies of the
jax-free modules it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device they raise.
"""
