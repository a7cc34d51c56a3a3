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
    f32 = tconfigs.config4_gibbs_smc(dtype=torch.float32)
    assert f32.data.y.dtype == torch.float32 and f32.data.device.type == "cpu"
