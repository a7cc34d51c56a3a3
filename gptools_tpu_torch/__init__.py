"""PyTorch + CUDA port of `gptools_tpu`, one slice at a time.

The JAX package `gptools_tpu` is the reference; this package mirrors its
module layout and names so each counterpart is easy to find. Configs 2, 3,
4 and 5 run through `infer.pipeline.smc_then_chees`, config 1 through the
multi-start MAP (`infer.map_fit`), and every sampler of `infer.run_sampler`
(NUTS, HMC, ChEES, parallel tempering, ADVI, SMC, SMC+NUTS) with the batched
evidence value-and-gradient in a hand-written CUDA kernel
(`ops.evidence_cuda`) where the reference's rules allow it, and through the
reference's XLA route written in torch elsewhere (config 5's transformed
observation, N past the kernel's 48, other kernels); `models.gp.
GaussianProcess` / `models.serve` answer predictions from the posterior,
their states built by a CUDA covariance kernel (`ops.cov_cuda`) with
``cov_backend="pallas"``; sources under `csrc/`. `parallel` shards the
chains over cards (one process per card, `torch.distributed`).
The package exports the reference's public names (models, kernels,
priors, means, diagnostics, configs, the frozen predictors). Importing it
loads torch and numpy only: no jax, no triton, and no kernel build (that
happens at the first CUDA call).

PyTorch runs eagerly, so none of the reference's XLA compile caches or
warm-compile threads exist here; the batched density keeps one identity
per (model, data) (`infer.model_logp`), as the reference's does.
"""

from gptools_tpu_torch.models.gp import GaussianProcess, GPModel, Prediction
from gptools_tpu_torch.models.dataset import Dataset, DatasetBuilder
from gptools_tpu_torch.models import mean
from gptools_tpu_torch.ops import kernels
from gptools_tpu_torch.ops.kernels import (
    SquaredExponentialKernel,
    MaternKernel,
    MaternGeneralKernel,
    Matern52Kernel,
    RationalQuadraticKernel,
    GibbsKernel,
    GibbsKernel1dTanh,
    DiagonalNoiseKernel,
    ZeroKernel,
    ConstantKernel,
    SumKernel,
    ProductKernel,
    WarpedKernel,
    MaskedKernel,
    ArbitraryKernel,
)
from gptools_tpu_torch.utils import priors
from gptools_tpu_torch.utils.priors import (
    UniformJointPrior,
    NormalJointPrior,
    LogNormalJointPrior,
    GammaJointPrior,
    GammaJointPriorAlt,
    ExponentialJointPrior,
    SortedUniformJointPrior,
    IndependentJointPrior,
    ProductJointPrior,
    CoreEdgeJointPrior,
)
from gptools_tpu_torch.utils import diagnostics
from gptools_tpu_torch.utils.diagnostics import ess, split_rhat, summarize_samples
from gptools_tpu_torch import configs
from gptools_tpu_torch.models.serve import FrozenMCMCPredictor, FrozenPredictor
from gptools_tpu_torch import parallel

__version__ = "0.1.0"

__all__ = [
    "GaussianProcess",
    "GPModel",
    "Prediction",
    "Dataset",
    "DatasetBuilder",
    "mean",
    "kernels",
    "priors",
    "diagnostics",
    "SquaredExponentialKernel",
    "MaternKernel",
    "MaternGeneralKernel",
    "Matern52Kernel",
    "RationalQuadraticKernel",
    "GibbsKernel",
    "GibbsKernel1dTanh",
    "DiagonalNoiseKernel",
    "ZeroKernel",
    "ConstantKernel",
    "SumKernel",
    "ProductKernel",
    "WarpedKernel",
    "MaskedKernel",
    "ArbitraryKernel",
    "UniformJointPrior",
    "NormalJointPrior",
    "LogNormalJointPrior",
    "GammaJointPrior",
    "GammaJointPriorAlt",
    "ExponentialJointPrior",
    "SortedUniformJointPrior",
    "IndependentJointPrior",
    "ProductJointPrior",
    "CoreEdgeJointPrior",
    "ess",
    "split_rhat",
    "summarize_samples",
    "configs",
    "FrozenPredictor",
    "FrozenMCMCPredictor",
    "parallel",
]
