"""fanlin-tpu on PyTorch and CUDA — the pixel and coefficient serving paths.

A port of `fanlin_tpu` (JAX/XLA/Pallas) to PyTorch for an NVIDIA
H100. It serves the same query API through the same HTTP entry point.
The host modules that hold no device code are carried over as copies
under the same names (config, spec, infra, utils.{bytelru, paths,
logging}, ops.filters, server.{router, timing}); the rest are ported
module by module under the same names:

  device      -> precision policy, explicit CUDA device
  ops.plan    -> per-image geometry plans and padded matrices
  ops.resample_kernels + csrc/resample.cu
              -> the hand-written CUDA resample kernel (replaces the
                 Pallas kernel of fanlin_tpu/ops/pallas_kernels.py)
  ops.jpeg_decode, ops.jpeg_decode_kernels + csrc/jpeg_decode.cu
              -> the coefficient decode (islow iDCT, upsample, colour):
                 plain torch versions and one fused CUDA kernel
  ops.fused   -> the transform chain, encode tails, BatchAssembly,
                 CoefBatchAssembly
  engine      -> codecs, jpeg_coeffs (the host JPEG entropy reader,
                 csrc/jpeg_coeffs.cpp, no libjpeg), processor (Engine)
  server      -> aiohttp gateway
  cli         -> ``python -m fanlin_tpu_torch.cli -j '{...}'``

This package imports torch and nothing of jax or of `fanlin_tpu`.
"""

__version__ = "0.1.0"
