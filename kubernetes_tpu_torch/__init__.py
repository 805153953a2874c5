"""kubernetes_tpu_torch — the PyTorch/CUDA port of the batch scheduler.

The JAX package ``kubernetes_tpu`` is the reference; this package runs the
same scheduling wave (encode -> sequential-commit solve -> node names) on
an NVIDIA H100, with the solve in a hand-written CUDA kernel
(``ops/csrc/commit_solve.cuh``). It imports torch and numpy, never jax, and
nothing of ``kubernetes_tpu``: every module it needs is copied here under
the reference's own path, trimmed to what the wave calls.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; the
CPU runs each kernel's plain PyTorch version.
"""
