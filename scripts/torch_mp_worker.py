#!/usr/bin/env python3
"""One rank of a multi-process run of the PyTorch port's sharded samplers.

    python scripts/torch_mp_worker.py --rank R --world W --port P \\
        --device cpu --out DIR [--config 4 --chains 16 --particles 64 \\
        --warmup 10 --samples 10 --seed 7 --extra --route-chains 16]

Start W of these (ranks 0..W-1, one free port). Each joins the group
through `parallel.distributed.initialize` (a TCP store on 127.0.0.1:P;
gloo, which also carries CUDA tensors, so two ranks may share one card),
builds `make_mesh`, runs the config through `smc_then_chees(mesh=...)`
from a generator seeded ``--seed`` on every rank and, with ``--extra``,
`sharded_smc` (seed + 1), one `training_step_sharded` step from its
start (seed + 2), a chain count the ranks do not divide (which must
raise ValueError) and a generator check with generators seeded by rank
(which must raise). With ``--route-chains C`` it also takes config 5's
log marginal and its gradient through the chains-minor route at C
thetas (seed + 3), C / W a rank, by ``log_marginal_batch(mesh=...)``. It
saves its global results to DIR/rank<R>.pt and prints one line
``MESH_WORKER {json}``: the walls, the evidence kernel's launches (and
the chain counts it saw), plain-version and route calls, and the
collectives. The counterpart of `scripts/mp_worker.py`;
`tests/test_torch_parallel.py` and `chip_smoke.py` phase 9b start it.
"""

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def route_check(prob, generator, chains, mesh=None):
    """Config 5's (``prob``) log marginal and its theta gradient at
    ``chains`` thetas drawn from ``generator``, with or without a mesh:
    (ll, grad, route calls), on the CPU."""
    from gptools_tpu_torch.ops import evidence_cuda

    model, data = prob.model, prob.data
    u = 0.4 * torch.randn(chains, model.num_free_params, generator=generator,
                          device=data.device, dtype=torch.float64)
    t = model.theta_of_u(u).requires_grad_(True)
    before = evidence_cuda.ROUTE_CALLS["chains_minor"]
    ll = model.log_marginal_batch(t, data, mesh=mesh)
    (g,) = torch.autograd.grad(ll.sum(), t)
    return ll.detach().cpu(), g.cpu(), evidence_cuda.ROUTE_CALLS["chains_minor"] - before


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", type=int, default=4)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--particles", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--samples", type=int, default=10)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--extra", action="store_true")
    ap.add_argument("--route-chains", type=int, default=0)
    a = ap.parse_args()

    torch.set_num_threads(1)
    if a.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed as dist

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.infer.pipeline import smc_then_chees
    from gptools_tpu_torch.ops import evidence_cuda
    from gptools_tpu_torch.parallel import distributed, make_mesh
    from gptools_tpu_torch.parallel import mesh as pmesh

    distributed.initialize(f"127.0.0.1:{a.port}", a.world, a.rank, backend="gloo")
    mesh = make_mesh(device_type=a.device)
    dev = torch.device(a.device, 0) if a.device == "cuda" else torch.device("cpu")
    prob = configs.ALL_CONFIGS[a.config](dtype=torch.float64, device=dev)

    seen = []
    vag = evidence_cuda.vag

    def recorded(thetaT, ev, aux=None):
        seen.append(int(thetaT.shape[1]))
        return vag(thetaT, ev, aux)

    evidence_cuda.vag = recorded
    evidence_cuda.reset_counts()
    pmesh.reset_counts()

    def gen(offset):
        return torch.Generator(device=dev).manual_seed(a.seed + offset)

    out, report = {}, {"rank": a.rank, "world": a.world}
    t0 = time.perf_counter()
    res = smc_then_chees(prob.model, prob.data, gen(0), num_chains=a.chains,
                         num_warmup=a.warmup, num_samples=a.samples, num_particles=a.particles,
                         mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    report["pipeline_s"] = time.perf_counter() - t0
    out["thetas"] = res.thetas.cpu()
    report.update(
        launches=sum(evidence_cuda.LAUNCHES.values()),
        plain=sum(evidence_cuda.PLAIN_CALLS.values()),
        route=sum(evidence_cuda.ROUTE_CALLS.values()),
        kernel_chains=sorted(set(seen)),
        collectives=dict(pmesh.COLLECTIVE_CALLS),
    )
    if a.extra:
        smc_res = pmesh.sharded_smc(prob.model, prob.data, gen(1), mesh=mesh,
                                    num_particles=a.particles)
        out["smc_u"] = smc_res.u.cpu()
        step, (u0, da0, inv_mass0) = pmesh.training_step_sharded(prob.model, prob.data, mesh,
                                                                 a.chains)
        q, logp, da, _ = step(u0, gen(2), da0, inv_mass0)
        out["step_q"], out["step_logp"], out["step_log_eps"] = q.cpu(), logp.cpu(), da.log_eps.cpu()
        try:  # a chain count the ranks do not divide
            smc_then_chees(prob.model, prob.data, gen(0), num_chains=a.world * 8 + 1, mesh=mesh)
            report["indivisible_raised"] = False
        except ValueError:
            report["indivisible_raised"] = True
        try:  # generators seeded differently on the ranks
            pmesh.check_generators(gen(a.rank), pmesh.chain_sharding(mesh))
            report["divergent_generators_raised"] = False
        except RuntimeError:
            report["divergent_generators_raised"] = True
    if a.route_chains:
        out["route_ll"], out["route_grad"], report["route_check_calls"] = route_check(
            configs.ALL_CONFIGS[5](dtype=torch.float64, device=dev), gen(3), a.route_chains,
            mesh)
    os.makedirs(a.out, exist_ok=True)
    torch.save(out, os.path.join(a.out, f"rank{a.rank}.pt"))
    dist.destroy_process_group()
    print("MESH_WORKER " + json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
