"""Run any of the five benchmark configurations end to end.

    python -m gptools_tpu_torch.examples.run_config 1          # SE GP MAP fit
    python -m gptools_tpu_torch.examples.run_config 4 --plot   # Gibbs profile fit via SMC
    python -m gptools_tpu_torch.examples.run_config 2 --cpu    # on the CPU
    torchrun --nproc-per-node=4 -m gptools_tpu_torch.examples.run_config 5  # over 4 cards

Counterpart of the JAX package's ``examples/run_config.py``: each config's
own sampler and sizes, uncut, on the card unless ``--cpu`` is given. Prints
a posterior or MAP summary; ``--plot`` writes the predictive envelope and
the corner plot (``<name>_fit.png``, ``<name>_corner.png``) to the current
directory. ``--mesh [N]`` shards the chains or particles of the ``smc``,
``smc+chees`` and ``smc+nuts`` samplers over the processes of a
``torchrun`` launch (one card each); config 5 takes the mesh by default
when there is more than one process. Randomness comes from a
``torch.Generator`` seeded with 0, whose stream differs from the
reference's ``PRNGKey(0)``.
"""

import argparse
import os
import time

import numpy as np

MESH_SAMPLERS = ("smc+chees", "smc+nuts", "smc")


def main(argv=None):
    """Run one configuration; returns its `MAPResult` (config 1) or
    `SampleResult`."""
    ap = argparse.ArgumentParser(prog="python -m gptools_tpu_torch.examples.run_config")
    ap.add_argument("config", type=int, choices=[1, 2, 3, 4, 5])
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument(
        "--mesh",
        type=int,
        nargs="?",
        const=-1,
        default=None,
        metavar="N",
        help="shard chains/particles over an N-process mesh (default: every process "
        "of the torchrun launch). Config 5 runs sharded by default when there is "
        "more than one process.",
    )
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.infer import map_fit, run_sampler
    from gptools_tpu_torch.parallel import distributed
    from gptools_tpu_torch.utils import plotting

    device = "cpu" if args.cpu else "cuda"
    # joins a torchrun launch's group (and picks this rank's card) before
    # anything is built; a no-op in a single process
    distributed.initialize(backend="gloo" if args.cpu else None)
    prob = configs.ALL_CONFIGS[args.config](device=device)
    print(f"== {prob.name}: {prob.description}")
    print(f"   data: {prob.data}")
    generator = torch.Generator(device=prob.data.device).manual_seed(0)

    sampler_kwargs = dict(prob.sampler_kwargs)
    mesh_n = args.mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh_n is None and args.config == 5 and world > 1:
        mesh_n = -1  # config 5 is the sharded config: use every process
    if mesh_n is not None and prob.sampler in MESH_SAMPLERS:
        from gptools_tpu_torch.parallel import make_mesh

        mesh = make_mesh(None if mesh_n == -1 else mesh_n, device_type=prob.data.device.type)
        sampler_kwargs["mesh"] = mesh
        print(f"   mesh: {mesh.size()} devices over axis {mesh.mesh_dim_names}")
    elif args.mesh is not None:
        print(
            f"   WARNING: --mesh ignored — sampler {prob.sampler!r} for "
            f"config {args.config} does not support mesh sharding (only "
            "smc/smc+chees/smc+nuts do); running unsharded."
        )

    t0 = time.perf_counter()
    names = prob.model.param_names
    if prob.sampler is None:
        res = map_fit.optimize(prob.model, prob.data, generator, **prob.sampler_kwargs)
        print(f"   MAP log posterior: {float(res.log_posterior):.3f}")
        for name, val in zip(names, res.theta.cpu().numpy()):
            print(f"   {name:>12s} = {val:.4f}")
        theta = res.theta
    else:
        res = run_sampler(prob.model, prob.data, generator, sampler=prob.sampler,
                          **sampler_kwargs)
        summary = plotting.summarize_sampler(res, param_names=names)
        print(f"   sampler: {prob.sampler}; wall: {time.perf_counter()-t0:.1f}s")
        for i, name in enumerate(summary["params"]):
            print(
                f"   {name:>12s} = {summary['mean'][i]:.4f} "
                f"+- {summary['std'][i]:.4f}  "
                f"[ESS {summary['ess'][i]:.0f}, Rhat {summary['rhat'][i]:.3f}]"
            )
        theta = res.thetas.reshape(-1, prob.model.num_params).mean(0)

    if args.plot:
        out = os.getcwd()  # the package's own directory may be read-only
        X = prob.truth["X"]
        xs = np.linspace(X.min(), X.max(), 200)
        pred = prob.model.predict(theta, prob.data, xs)
        ax = plotting.univariate_envelope_plot(xs, pred.mean, std=pred.std, label="posterior")
        truth_key = "f" if "f" in prob.truth else "profile"
        ax.plot(X, prob.truth[truth_key], "k--", label="truth")
        ax.legend()
        fig_path = os.path.join(out, f"{prob.name}_fit.png")
        ax.figure.savefig(fig_path, dpi=120)
        print(f"   wrote {fig_path}")
        if prob.sampler is not None:
            corner_path = os.path.join(out, f"{prob.name}_corner.png")
            plotting.plot_sampler(res, param_names=names, path=corner_path)
            print(f"   wrote {corner_path}")
    return res


if __name__ == "__main__":
    main()
