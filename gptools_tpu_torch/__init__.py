"""PyTorch + CUDA port of `gptools_tpu`, one slice at a time.

The JAX package `gptools_tpu` is the reference; this package mirrors its
module layout and names so each counterpart is easy to find. Configs 2, 3,
4 and 5 run through `infer.pipeline.smc_then_chees` with the batched
evidence value-and-gradient in a hand-written CUDA kernel
(`ops.evidence_cuda`) where the reference's rules allow it, and through the
reference's XLA route written in torch elsewhere (config 5's transformed
observation, N past the kernel's 48, other kernels); `models.gp.
GaussianProcess` / `models.serve` answer predictions from the posterior,
their states built by a CUDA covariance kernel (`ops.cov_cuda`) with
``cov_backend="pallas"``; sources under `csrc/`.
Importing the package loads torch and numpy only: no jax, no triton, and
no kernel build (that happens at the first CUDA call).

PyTorch runs eagerly, so none of the reference's XLA compile caches,
warm-compile threads or function-identity caches exist here.
"""

__version__ = "0.1.0"
