"""PyTorch + CUDA port of `gptools_tpu`, one slice at a time.

The JAX package `gptools_tpu` is the reference; this package mirrors its
module layout and names so each counterpart is easy to find. The first
slice is the flagship path: config 4 (Gibbs-tanh GP, N = 27, P = 5) through
`infer.pipeline.smc_then_chees`, with the batched evidence value-and-
gradient in a hand-written CUDA kernel (`ops.evidence_cuda`, sources under
`csrc/`). Importing the package loads torch and numpy only: no jax, no
triton, and no kernel build (that happens at the first CUDA call).

PyTorch runs eagerly, so none of the reference's XLA compile caches,
warm-compile threads or function-identity caches exist here.
"""

__version__ = "0.1.0"
