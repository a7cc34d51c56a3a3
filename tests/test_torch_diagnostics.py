"""The port's chain diagnostics against the JAX package, float64.

- `ess_per_param`, `split_rhat`, `rank_normalize`, `bulk_ess_per_param`,
  `_device_moments` and `summarize_samples` (host path through the native
  library, and with ``native=False`` through torch on the CPU) on the same
  draws as the reference's: rtol 1e-12;
- `ess_and_rhat` on a CPU tensor (the native library) and with
  ``native=False`` (torch) against the reference's host path;
- the port's own binding of ``native/diagnostics.cpp`` (`utils.native`,
  built into ``gptools_tpu_torch/_build/``) against the reference's
  (`gptools_tpu.utils.native`, built by its Makefile) at rtol 1e-12, on AR(1)
  chains that stop the Geyer scan early and random walks that exhaust its
  pair budget (the FFT fallback);
- a failed build raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu.utils import diagnostics as jdiag
from gptools_tpu.utils import native as jnative
from gptools_tpu_torch.utils import diagnostics as tdiag
from gptools_tpu_torch.utils import native as tnative

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


def _draws(kind, seed=0, m=4, n=300, d=3):
    rng = np.random.default_rng(seed)
    if kind == "walk":  # autocorrelation positive past the native pair budget
        return np.cumsum(rng.standard_normal((m, n, d)), 1) * 0.1 + rng.standard_normal((m, n, d))
    x = np.zeros((m, n, d))
    x[:, 0] = rng.standard_normal((m, d))
    for t in range(1, n):
        x[:, t] = 0.7 * x[:, t - 1] + rng.standard_normal((m, d))
    return x + 0.1 * np.arange(m)[:, None, None] * np.arange(1, d + 1)


@pytest.mark.parametrize("kind", ["ar1", "walk"])
@pytest.mark.parametrize("name", ["ess_per_param", "split_rhat", "bulk_ess_per_param",
                                  "rank_normalize"])
def test_diagnostic_matches_jax(name, kind):
    x = _draws(kind)
    got = getattr(tdiag, name)(torch.tensor(x)).numpy()
    want = np.asarray(jax.jit(getattr(jdiag, name))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_moments_and_summary_match_jax():
    x = _draws("ar1", seed=3)
    got = [v.numpy() for v in tdiag._device_moments(torch.tensor(x))]
    want = [np.asarray(v) for v in jdiag._device_moments(jnp.asarray(x))]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    ref = jdiag.summarize_samples(x, param_names=["a", "b", "c"], wall_time=2.5)
    for native in (True, False):
        out = tdiag.summarize_samples(torch.tensor(x), param_names=["a", "b", "c"],
                                      wall_time=2.5, native=native)
        assert out["params"] == ref["params"]
        assert (out["num_chains"], out["num_samples"]) == (4, 300)
        for k in ("mean", "std", "q05", "q50", "q95", "ess", "rhat", "ess_per_s"):
            np.testing.assert_allclose(out[k], ref[k], **TOL, err_msg=k)


@pytest.mark.parametrize("kind", ["ar1", "walk"])
def test_ess_and_rhat_host_paths(kind):
    x = _draws(kind, seed=7)
    e_ref, r_ref = jdiag.ess_and_rhat(x)
    for native in (True, False):
        e, r = tdiag.ess_and_rhat(torch.tensor(x), native=native)
        np.testing.assert_allclose(e, e_ref, **TOL)
        np.testing.assert_allclose(r, r_ref, **TOL)


@pytest.mark.parametrize("kind", ["ar1", "walk"])
def test_native_binding_matches_reference(kind):
    if jnative.load(auto_build=True) is None:
        pytest.fail("the reference's native library did not build")
    x = _draws(kind, seed=11, m=6, n=400, d=4)
    np.testing.assert_allclose(tnative.ess_batch(x), jnative.ess_batch(x), **TOL)
    np.testing.assert_allclose(tnative.split_rhat_batch(x), jnative.split_rhat_batch(x),
                               **TOL)
    assert tnative.build().parent.name == "_build"


def test_failed_native_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "diagnostics.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SOURCE", bad)
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        tnative.build()
