"""The port's mesh layer (`parallel/`) on the CPU with gloo, float64.

In process, at world size 1 (a group of one that `make_mesh` makes):

- the mesh, its axis names, the chain sharding and `shard_chains`, and the
  ValueError on a count the shards do not divide;
- `distributed.initialize()` a no-op without a cluster, `pod_mesh()` of
  shape (1, 1), `is_multiprocess()` false;
- `log_marginal_batch`, `log_posterior_batch` and `log_posterior_u_batch`
  with ``mesh=`` equal to the same calls without (bitwise), the first
  within 1e-9 of the JAX package's ``log_marginal_batch(..., mesh=
  make_mesh())`` on its 8 virtual CPU devices; under autograd the same
  gradient;
- `sharded_sample`'s NUTS on a correlated Gaussian at the moments
  ``tests/test_parallel.py`` asserts for the reference;
- `sharded_smc` equal to the unsharded SMC (bitwise);
- `training_step_sharded` runs and counts collectives;
- `pt_step_sharded` on a (1, 1) pod mesh: shapes, finite values,
  acceptance, as ``tests/test_parallel.py`` holds the reference's.

Two ranks (`scripts/torch_mp_worker.py`, gloo over 127.0.0.1): configs 4
and 3 (each on its own pair of ranks) through ``smc_then_chees(mesh=...)``
(64 particles, 16 chains, 10 + 10), and for config 4 also
`sharded_smc` and one `training_step_sharded` step; on every rank each
draw within 1e-10 of the single-process unsharded run from the same seed
(0 expected: the density's rows do not depend on the batch's width);
config 5's log marginal and gradient through the chains-minor route, 8
thetas a rank, equal to the unsharded call at 16 (bitwise); a
chain count the ranks do not divide raising ValueError, and generators
seeded by rank refused.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gptools_tpu import configs as jconfigs
from gptools_tpu.parallel import make_mesh as jmake_mesh
from gptools_tpu_torch import configs as tconfigs
from gptools_tpu_torch.infer import hmc, model_logp, nuts, smc
from gptools_tpu_torch.infer.pipeline import smc_then_chees
from gptools_tpu_torch.models.dataset import DatasetBuilder
from gptools_tpu_torch.models.gp import GPModel
from gptools_tpu_torch.ops.kernels import SquaredExponentialKernel
from gptools_tpu_torch.parallel import (
    chain_sharding,
    distributed,
    make_mesh,
    shard_chains,
    sharded_sample,
    sharded_smc,
)
from gptools_tpu_torch.parallel import mesh as pmesh
from gptools_tpu_torch.utils.priors import LogNormalJointPrior

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "torch_mp_worker.py")
F64 = torch.float64


@pytest.fixture(scope="module")
def mesh():
    m = make_mesh(device_type="cpu")
    yield m
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def config4():
    prob = tconfigs.config4_gibbs_smc(dtype=F64, device="cpu")
    return prob.model, prob.data


def _tiny_gp():
    rng = np.random.default_rng(0)
    X = np.linspace(0, 2, 10)
    b = DatasetBuilder(1)
    b.add(X, np.sin(X) + 0.05 * rng.standard_normal(10), err_y=0.05)
    model = GPModel(SquaredExponentialKernel(hyperprior=LogNormalJointPrior([0, -1], [1, 1])))
    return model, b.build(F64, "cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_mesh_and_sharding(mesh):
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("chains",)
    assert mesh.device_type == "cpu"
    sh = chain_sharding(mesh)
    assert (sh.count, sh.index, sh.device) == (1, 0, torch.device("cpu"))
    assert sh.block(16) == slice(0, 16)
    tree = {"u": torch.arange(12.0).reshape(6, 2), "da": hmc.da_init(torch.tensor(0.1)),
            "n": 3}
    out = shard_chains(tree, mesh)
    assert torch.equal(out["u"], tree["u"]) and out["n"] == 3
    assert isinstance(out["da"], hmc.DualAveragingState)
    # a count the shards do not divide
    with pytest.raises(ValueError, match="num_chains 15 must be a multiple of mesh size 2"):
        pmesh.ChainSharding(None, 2, 0, torch.device("cpu")).block(15)
    with pytest.raises(ValueError):
        chain_sharding(mesh, "temps")
    with pytest.raises(ValueError):
        make_mesh(2, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()  # the mesh never runs on the CPU unless asked


def test_pod_mesh_single_process(mesh):
    distributed.initialize()  # no cluster named: a no-op
    assert not distributed.is_multiprocess()
    pod = distributed.pod_mesh(device_type="cpu")
    assert tuple(pod.mesh.shape) == (1, 1) and pod.mesh_dim_names == ("dcn", "ici")
    sh = distributed.chain_sharding_2d(pod)
    assert (sh.count, sh.index) == (1, 0)


@pytest.mark.parametrize("method", ["log_marginal_batch", "log_posterior_batch",
                                    "log_posterior_u_batch"])
def test_batch_densities_with_mesh(mesh, config4, method):
    model, data = config4
    rng = np.random.default_rng(8)
    us = torch.tensor(0.4 * rng.standard_normal((16, 5)), dtype=F64)
    x = us if method == "log_posterior_u_batch" else model.theta_of_u(us)
    fn = getattr(model, method)
    want = fn(x, data)
    got = fn(x, data, mesh=mesh)
    assert torch.equal(got, want)
    # under autograd: the rank's gradient, gathered, equals the unsharded one
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(fn(xg, data, mesh=mesh, mesh_axis="chains").sum(), xg)
    xg = x.clone().requires_grad_(True)
    (g0,) = torch.autograd.grad(fn(xg, data).sum(), xg)
    assert torch.equal(g, g0)
    if method == "log_marginal_batch":
        jprob, jmesh = jconfigs.config4_gibbs_smc(), jmake_mesh()
        ref = jax.jit(lambda th: jprob.model.log_marginal_batch(th, jprob.data, mesh=jmesh))(
            jnp.asarray(x.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9)


_COV = np.array([[1.0, 0.5], [0.5, 2.0]])
_PREC = torch.tensor(np.linalg.inv(_COV))


def _gauss_logp(u):
    return -0.5 * ((u @ _PREC) * u).sum(-1)


def test_sharded_nuts_gaussian_moments(mesh):
    u0 = torch.randn(16, 2, dtype=F64, generator=_gen(0))
    pmesh.reset_counts()
    res = sharded_sample(_gauss_logp, u0, _gen(1), mesh=mesh, num_warmup=300,
                         num_samples=400)
    flat = res.u.reshape(-1, 2).numpy()
    np.testing.assert_allclose(flat.mean(axis=0), [0, 0], atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), _COV, atol=0.5)
    assert pmesh.COLLECTIVE_CALLS["density"] > 0 and pmesh.COLLECTIVE_CALLS["check"] == 1


def test_sharded_smc_equals_unsharded(mesh):
    model, data = _tiny_gp()
    ref = smc.sample(model, data, _gen(3), num_particles=64)
    got = sharded_smc(model, data, _gen(3), mesh=mesh, num_particles=64)
    assert torch.equal(got.u, ref.u)
    assert torch.equal(got.diagnostics["log_evidence"], ref.diagnostics["log_evidence"])


def test_training_step_sharded_runs(mesh):
    model, data = _tiny_gp()
    pmesh.reset_counts()
    step, (u0, da0, inv_mass0) = pmesh.training_step_sharded(model, data, mesh, 16)
    q1, logp, da1, stats = step(u0, _gen(4), da0, inv_mass0)
    assert q1.shape == (16, 2) and torch.isfinite(logp).all()
    assert torch.isfinite(torch.exp(da1.log_eps)) and int(da1.t) == 1
    assert stats["accept_prob"].shape == (16,)
    assert pmesh.COLLECTIVE_CALLS["density"] > 0


def test_pt_step_sharded_2d_mesh(mesh):
    model, data = _tiny_gp()
    pod = distributed.pod_mesh(("temps", "chains"), device_type="cpu")
    step, (u0, eps0, inv_mass0) = pmesh.pt_step_sharded(model, data, pod, num_temps=4,
                                                        num_chains=6, num_steps=4)
    assert u0.shape == (4, 6, 2) and eps0.shape == (4,) and inv_mass0.shape == (4, 2)
    u, gen = torch.full((4, 6, 2), 0.1, dtype=F64), _gen(5)
    accepts = []
    for i in range(4):
        u, ll, swap_frac, accept = step(u, gen, eps0, inv_mass0, i)
        accepts.append(accept)
    assert u.shape == (4, 6, 2) and torch.isfinite(u).all() and torch.isfinite(ll).all()
    assert ll.shape == (4, 6) and swap_frac.shape == (3,)
    assert float(torch.stack(accepts).mean()) > 0.1


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_ranks_gloo_equal_unsharded(tmp_path, config4):
    """Config 4 on two gloo ranks against the single-process unsharded run:
    the pipeline's draws, SMC's particles and a training step's positions,
    log densities and step size; config 5 through the route; config 3 (the
    evidence kernel with the aux channels mu and w) through the pipeline,
    on two more ranks."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    runs = {4: ["--extra", "--route-chains", "16"], 3: ["--config", "3"]}
    procs = {}
    for config, extra in runs.items():
        port = _free_port()
        procs[config] = [subprocess.Popen(
            [sys.executable, WORKER, "--rank", str(r), "--world", "2", "--port", str(port),
             "--device", "cpu", "--out", str(tmp_path / f"config{config}"), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(2)]
    outs = {config: [] for config in runs}
    try:
        for config, ps in procs.items():
            for p in ps:
                outs[config].append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for ps in procs.values():
            for p in ps:
                p.kill()
        pytest.fail("two-rank workers timed out:\n" + "\n".join(sum(outs.values(), [])))

    model, data = config4
    ref = smc_then_chees(model, data, _gen(7), num_chains=16, num_warmup=10, num_samples=10,
                         num_particles=64)
    ref_smc = smc.sample(model, data, _gen(8), num_particles=64)
    transition = nuts.nuts_transition_builder(max_depth=8)(
        hmc.value_and_grad(model_logp(model, data)))
    u0 = torch.zeros(16, 5, dtype=F64)
    da0 = hmc.da_init(torch.tensor(0.1, dtype=F64))
    q, logp, _, stats = transition(u0, None, None, _gen(9), torch.exp(da0.log_eps),
                                   torch.ones(5, dtype=F64))
    log_eps = hmc.da_update(da0, stats["accept_prob"].mean()).log_eps
    spec = importlib.util.spec_from_file_location("torch_mp_worker", WORKER)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    route_ll, route_grad, _ = worker.route_check(
        tconfigs.ALL_CONFIGS[5](dtype=F64, device="cpu"), _gen(10), 16)

    prob3 = tconfigs.ALL_CONFIGS[3](dtype=F64, device="cpu")
    ref3 = smc_then_chees(prob3.model, prob3.data, _gen(7), num_chains=16, num_warmup=10,
                          num_samples=10, num_particles=64)

    worst = 0.0
    for r, (p, out) in enumerate(zip(procs[3], outs[3])):
        assert p.returncode == 0, f"config 3 rank {r} failed:\n{out}"
        report = json.loads(out.split("MESH_WORKER ", 1)[1].splitlines()[0])
        assert report["kernel_chains"] == [8, 32], report
        assert report["collectives"]["density"] > 0 and report["plain"] > 0
        got = torch.load(tmp_path / "config3" / f"rank{r}.pt")
        assert got["thetas"].shape == ref3.thetas.shape
        worst = max(worst, float((got["thetas"] - ref3.thetas).abs().max()))
    for r, (p, out) in enumerate(zip(procs[4], outs[4])):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        report = json.loads(out.split("MESH_WORKER ", 1)[1].splitlines()[0])
        assert report["indivisible_raised"] and report["divergent_generators_raised"]
        # each rank's density calls covered its half: 8 chains, 32 particles
        assert report["kernel_chains"] == [8, 32], report
        assert report["collectives"]["density"] > 0 and report["plain"] > 0
        assert report["route_check_calls"] == 1, report
        got = torch.load(tmp_path / "config4" / f"rank{r}.pt")
        # config 5's route on 8 thetas a rank: the unsharded call's bits
        assert torch.equal(got["route_ll"], route_ll)
        assert torch.equal(got["route_grad"], route_grad)
        for a, b in ((got["thetas"], ref.thetas), (got["smc_u"], ref_smc.u),
                     (got["step_q"], q), (got["step_logp"], logp),
                     (got["step_log_eps"], log_eps)):
            assert a.shape == b.shape
            worst = max(worst, float((a - b).abs().max()))
    print(f"largest difference from the unsharded run: {worst:.3e}")
    assert worst <= 1e-10
