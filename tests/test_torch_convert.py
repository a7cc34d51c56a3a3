"""Carrying the JAX package's config-4 model and data across (`convert`),
and the port's own config-4 builder, reproduce names, order and data
exactly."""

import math

import numpy as np
import torch

from gptools_tpu import configs as jconfigs
from gptools_tpu_torch import configs as tconfigs
from gptools_tpu_torch import convert
from gptools_tpu_torch.utils import bijectors as tbij

torch.set_num_threads(1)


def test_model_from_jax_round_trip():
    jm = jconfigs.config4_gibbs_smc().model
    tm = convert.model_from_jax(jm)
    assert tm.param_names == jm.param_names == (
        "k.sigma_f", "k.l1", "k.l2", "k.lw", "k.x0"
    )
    assert tm.initial_params == jm.initial_params
    assert tm.fixed_params == jm.fixed_params
    assert tm.free_idx == jm.free_idx
    assert tm.diag_factor == jm.diag_factor
    assert list(tm.param_bounds) == list(jm.param_bounds)
    jparts, tparts = jm.hyperprior.parts, tm.hyperprior.parts
    assert [type(p).__name__ for p in tparts] == [type(p).__name__ for p in jparts]
    for jp, tp in zip(jparts, tparts):
        for attr in ("mu", "sigma", "lb", "ub"):
            assert getattr(tp, attr, None) == getattr(jp, attr, None)
    assert isinstance(tm.bijector, tbij.ConcatBijector)
    assert tm.hyperprior.bounds[0] == (0.0, math.inf)


def test_dataset_from_jax_round_trip():
    jd = jconfigs.config4_gibbs_smc().data
    td = convert.dataset_from_jax(jd, torch.float64, "cpu")
    assert td.multi_indices == jd.multi_indices == ((0,), (1,))
    np.testing.assert_array_equal(td.Xf.numpy(), np.asarray(jd.Xf))
    np.testing.assert_array_equal(td.nid.numpy(), np.asarray(jd.nid))
    np.testing.assert_array_equal(td.y.numpy(), np.asarray(jd.y))
    np.testing.assert_array_equal(td.err_y.numpy(), np.asarray(jd.err_y))
    assert td.nid.dtype == torch.int32 and td.num_obs == 27
    th = convert.thetas_from_numpy(np.ones((3, 5)), torch.float32, "cpu")
    assert th.dtype == torch.float32 and th.shape == (3, 5)


def test_port_config4_equals_jax_config4():
    jp = jconfigs.config4_gibbs_smc(seed=3)
    tp = tconfigs.config4_gibbs_smc(seed=3, dtype=torch.float64, device="cpu")
    assert tp.model.param_names == jp.model.param_names
    for name in ("Xf", "nid", "y", "err_y"):
        np.testing.assert_array_equal(
            getattr(tp.data, name).numpy(), np.asarray(getattr(jp.data, name))
        )
    assert tp.data.multi_indices == jp.data.multi_indices
    f32 = tconfigs.config4_gibbs_smc(dtype=torch.float32, device="cpu")
    assert f32.data.y.dtype == torch.float32 and f32.data.device.type == "cpu"


def _zoo_models():
    """One reference model per type this slice carries across."""
    from gptools_tpu.models import mean as jm
    from gptools_tpu.models.gp import GPModel
    from gptools_tpu.ops import kernels as jk
    from gptools_tpu.utils import priors as jp

    nu_prior = (jp.LogNormalJointPrior([0.0], [0.75]) * jp.UniformJointPrior([1.05], [6.0])
                * jp.LogNormalJointPrior([-0.5], [0.75]))
    sorted_prior = (jp.GammaJointPrior([2.0], [1.0]) * jp.CoreEdgeJointPrior(2, 0.01, 1.0)
                    * jp.ExponentialJointPrior([3.0]) * jp.IndependentJointPrior(
                        [jp.Uniform(0.5, 1.2)]))
    masked = jk.MaskedKernel(jk.SquaredExponentialKernel(), 2, [1])
    masked.param_bounds[1] = (0.05, 5.0)  # changed after construction
    return {
        "matern_general": GPModel(jk.MaternGeneralKernel(hyperprior=nu_prior)),
        "rq_sum_noise": GPModel(
            jk.RationalQuadraticKernel(hyperprior=jp.LogNormalJointPrior([0.0], [0.75])
                                       * jp.GammaJointPriorAlt([2.0], [1.0])
                                       * jp.SortedUniformJointPrior(1, 0.1, 3.0))
            + jk.DiagonalNoiseKernel(), noise_kernel=jk.ConstantKernel()),
        "product_scaled_masked": GPModel(
            2.0 * (masked * jk.MaskedKernel(jk.RationalQuadraticKernel(), 2, [0]))
            + jk.ZeroKernel(2)),
        "gibbs_gauss_sorted": GPModel(jk.GibbsKernel1dGauss(hyperprior=sorted_prior),
                                      mean=jm.LinearMeanFunction() + jm.ConstantMeanFunction()),
        "gibbs_exp": GPModel(jk.GibbsKernel1dExp()),
        "gibbs_interpolated": GPModel(jk.GibbsKernel(jk.InterpolatedWarp([0.0, 0.4, 1.0]))),
        "gibbs_tanh_generic": GPModel(jk.GibbsKernel(jk.TanhWarp()),
                                      noise_kernel=jk.DiagonalNoiseKernel(n=1)),
        "normal_independent": GPModel(jk.SquaredExponentialKernel(
            hyperprior=jp.IndependentJointPrior([jp.Normal(1.0, 0.2), jp.LogNormal(0.0, 1.0)]))),
    }


def _same_tree(j, t):
    """Types and metadata agree, part for part, down the combination tree."""
    assert type(t).__name__ == type(j).__name__
    for attr in ("param_names", "initial_params", "fixed_params", "num_dim", "active_dims",
                 "factor", "knots"):
        if hasattr(j, attr):
            assert tuple(np.ravel(getattr(t, attr))) == tuple(np.ravel(getattr(j, attr))), attr
    if hasattr(j, "param_bounds"):
        assert list(t.param_bounds) == list(j.param_bounds)
    for child in ("k1", "k2", "base", "m1", "m2", "warp"):
        if hasattr(j, child):
            _same_tree(getattr(j, child), getattr(t, child))


def _same_prior(j, t):
    jparts, tparts = getattr(j, "parts", (j,)), getattr(t, "parts", (t,))
    assert [type(p).__name__ for p in tparts] == [type(p).__name__ for p in jparts]
    for jp, tp in zip(jparts, tparts):
        assert tp.bounds == jp.bounds
        for attr in ("mu", "sigma", "lb", "ub", "a", "b", "mode", "std", "rate", "dim"):
            if hasattr(jp, attr):
                assert getattr(tp, attr) == getattr(jp, attr), attr
        for dj, dt in zip(getattr(jp, "univariates", ()), getattr(tp, "univariates", ())):
            assert type(dt).__name__ == type(dj).__name__ and dt.bounds == dj.bounds


def test_zoo_models_carry_across():
    """Every kernel, warp, prior and mean of this slice carries across with
    its type, parameters, bounds (also ones changed after construction),
    priors and combination tree."""
    for name, jm in _zoo_models().items():
        tm = convert.model_from_jax(jm)
        assert tm.param_names == jm.param_names, name
        assert tm.initial_params == jm.initial_params, name
        assert list(tm.param_bounds) == list(jm.param_bounds), name
        _same_tree(jm.kernel, tm.kernel)
        _same_prior(jm.kernel.hyperprior, tm.kernel.hyperprior)
        if jm.noise_kernel is not None:
            _same_tree(jm.noise_kernel, tm.noise_kernel)
        if jm.mean is not None:
            _same_tree(jm.mean, tm.mean)
        assert [off for off, _ in tm.kernel.delta_terms()] == [
            off for off, _ in jm.kernel.delta_terms()]


def test_callables_do_not_carry_across():
    """A part that holds a JAX callable raises TypeError and names the
    port's class, which takes a torch callable."""
    import pytest

    from gptools_tpu.models import mean as jm
    from gptools_tpu.models.gp import GPModel
    from gptools_tpu.ops import kernels as jk

    se = jk.SquaredExponentialKernel()
    parts = {
        "ArbitraryKernel": GPModel(jk.ArbitraryKernel(lambda a, b, t: t[0], 1, ("c",))),
        "ChainRuleKernel": GPModel(jk.ChainRuleKernel(lambda v, t: v, lambda a, b, t: t[0], 1,
                                                      ("c",)) + se),
        "ArbitraryWarp": GPModel(jk.WarpedKernel(se, jk.ArbitraryWarp(lambda x, t: x))),
        "ArbitraryMeanFunction": GPModel(se, mean=jm.ArbitraryMeanFunction(
            lambda x, t: t[0], 1, ("c",))),
    }
    for name, model in parts.items():
        with pytest.raises(TypeError, match=f"{name} holds a JAX callable.*torch callable"):
            convert.model_from_jax(model)
