"""The port's Bessel-K (`gptools_tpu_torch.ops.special.bessel_kve`,
`log_bessel_k`) against the JAX package's and against scipy, float64.

Values within 1e-12 (relative) and the nu- and x-gradients within 1e-10
of the reference's, over nu in {0, 0.3, 1, 1.5, 2.7, 5.5, 12.25, 31.9} x
x in {1e-3, 1e-2, 0.1, 1, 10, 50}; against `scipy.special.kve` at the
reference's own accuracy (tests/test_special.py: rtol 5e-6 for x >= 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import torch

from gptools_tpu.ops import special as jspecial
from gptools_tpu_torch.ops import special as tspecial

torch.set_num_threads(1)

NUS = [0.0, 0.3, 1.0, 1.5, 2.7, 5.5, 12.25, 31.9]
XS = [1e-3, 1e-2, 0.1, 1.0, 10.0, 50.0]


@pytest.fixture(scope="module")
def reference():
    """The reference's values, log values and (nu, x) gradients over the
    whole grid, from one jitted call."""
    V, X = (a.ravel() for a in np.meshgrid(NUS, XS, indexing="ij"))

    def one(v, x):
        val, grads = jax.value_and_grad(jspecial.bessel_kve, argnums=(0, 1))(v, x)
        return val, jspecial.log_bessel_k(v, x), grads[0], grads[1]

    out = jax.jit(jax.vmap(one))(jnp.asarray(V), jnp.asarray(X))
    return V, X, [np.asarray(o) for o in out]


def _port(V, X, **kw):
    v = torch.tensor(V, requires_grad=True)
    x = torch.tensor(X, requires_grad=True)
    val = tspecial.bessel_kve(v, x, **kw)
    gv, gx = torch.autograd.grad(val.sum(), (v, x))
    log = tspecial.log_bessel_k(v.detach(), x.detach(), **kw)
    return val.detach().numpy(), log.numpy(), gv.numpy(), gx.numpy()


@pytest.mark.parametrize("nu", NUS)
def test_bessel_kve_matches_jax(reference, nu):
    V, X, (val, log, gv, gx) = reference
    rows = V == nu
    t_val, t_log, t_gv, t_gx = _port(V[rows], X[rows])
    np.testing.assert_allclose(t_val, val[rows], rtol=1e-12, atol=0)
    np.testing.assert_allclose(t_log, log[rows], rtol=1e-12, atol=1e-12)
    scale_v = np.abs(gv[rows]).max()
    np.testing.assert_allclose(t_gv, gv[rows], rtol=1e-10, atol=1e-10 * scale_v)
    np.testing.assert_allclose(t_gx, gx[rows], rtol=1e-10, atol=0)


@pytest.mark.parametrize("nu", [0.0, 0.5, 1.0, 1.7, 2.5, 7.3, 15.0, 30.0])
def test_bessel_kve_matches_scipy(nu):
    x = np.array([1e-2, 0.1, 0.5, 1.0, 3.0, 10.0, 50.0])
    got = tspecial.bessel_kve(torch.tensor(nu, dtype=torch.float64), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, sps.kve(nu, x), rtol=5e-6)


def test_static_loop_length_equals_the_full_recurrence(rng):
    """A loop cut at max_order = floor(nu_max) gives the 63-step result
    bit for bit; an order past the cut gives NaN, never a wrong number."""
    v = torch.tensor(rng.uniform(0.0, 6.99, 64))
    x = torch.tensor(rng.uniform(0.01, 20.0, 64))
    full = tspecial.bessel_kve(v, x)
    cut = tspecial.bessel_kve(v, x, max_order=6)
    assert torch.equal(full, cut)
    past = tspecial.bessel_kve(torch.tensor([7.5]), torch.tensor([1.0]), max_order=6)
    assert torch.isnan(past).all()


def test_x_derivatives_under_jvp_towers():
    """Under nested torch.func.jvp (the derivative blocks' towers) every
    argument is a dual tensor: the first and second x-derivatives match the
    reference's autodiff, with nu carried along."""
    nu = torch.tensor([1.3, 2.7, 4.2], dtype=torch.float64)
    x = torch.tensor([0.4, 1.7, 6.0], dtype=torch.float64)
    one = torch.ones_like(x)

    def d1(xx):
        return torch.func.jvp(lambda a: tspecial.bessel_kve(nu, a, max_order=4), (xx,),
                              (one,))[1]

    g1 = d1(x)
    g2 = torch.func.jvp(d1, (x,), (one,))[1]
    f = jspecial.bessel_kve
    jg1 = jax.vmap(jax.grad(f, 1))(jnp.asarray(nu.numpy()), jnp.asarray(x.numpy()))
    jg2 = jax.vmap(jax.grad(jax.grad(f, 1), 1))(jnp.asarray(nu.numpy()), jnp.asarray(x.numpy()))
    np.testing.assert_allclose(g1.numpy(), np.asarray(jg1), rtol=1e-10)
    np.testing.assert_allclose(g2.numpy(), np.asarray(jg2), rtol=1e-10)


def test_node_tables_made_once_outside_transforms():
    """The node tables are made once per (dtype, device), and the first use
    inside a jvp tower does not leave a tensor of that tower's level in the
    cache."""
    tspecial._nodes_on.cache_clear()
    x = torch.tensor([0.5, 2.0], dtype=torch.float64)
    torch.func.jvp(lambda a: tspecial.bessel_kve(torch.tensor(1.5, dtype=torch.float64), a),
                   (x,), (torch.ones_like(x),))
    nodes = tspecial._nodes_on("exp_sinh", 384, 3.8, torch.float64, x.device)
    assert not any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in nodes)
    assert nodes is tspecial._nodes_on("exp_sinh", 384, 3.8, torch.float64, x.device)
    # and the cached table serves a later tower
    out = torch.func.jvp(lambda a: tspecial.bessel_kve(torch.tensor(1.5, dtype=torch.float64),
                                                       a), (x,), (torch.ones_like(x),))
    assert torch.isfinite(out[1]).all()
