"""fanlin-tpu on PyTorch and CUDA — the pixel-source serving path.

A port of `fanlin_tpu` (JAX/XLA/Pallas) to PyTorch for an NVIDIA
H100. It serves the same query API through the same HTTP entry point.
Host modules that import no jax are reused from `fanlin_tpu` by import
(config, spec, infra, utils, ops.filters, server.router/timing); the
rest are ported module by module under the same names:

  device      -> precision policy, explicit CUDA device
  ops.plan    -> per-image geometry plans and padded matrices
  ops.resample_kernels + csrc/resample.cu
              -> the hand-written CUDA resample kernel (replaces the
                 Pallas kernel of fanlin_tpu/ops/pallas_kernels.py)
  ops.fused   -> the transform chain, encode tails, BatchAssembly
  engine      -> codecs, processor (Engine)
  server      -> aiohttp gateway
  cli         -> ``python -m fanlin_tpu_torch.cli -j '{...}'``

This package imports torch and never jax.
"""

__version__ = "0.1.0"
