"""The reference's canonical worked example on the card: synthetic
sine-wave regression with a derivative constraint at the edge, done three
ways: MAP, NUTS, and fully-Bayesian prediction.

    python -m gptools_tpu_torch.examples.sine_derivative_constraint
    python -m gptools_tpu_torch.examples.sine_derivative_constraint --cpu

Counterpart of the JAX package's ``examples/sine_derivative_constraint.py``
through the port's `GaussianProcess`: the same data, prior, calls and
printed lines. ``--cpu`` runs it on the CPU instead of the card.
"""

import argparse

import numpy as np


def main(argv=None):
    """Run the example; returns ``{"gp", "map", "posterior", "slope",
    "slope_std"}``."""
    ap = argparse.ArgumentParser(
        prog="python -m gptools_tpu_torch.examples.sine_derivative_constraint")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from gptools_tpu_torch import GaussianProcess, SquaredExponentialKernel
    from gptools_tpu_torch.utils.priors import LogNormalJointPrior

    rng = np.random.default_rng(0)
    X = np.linspace(0, 3, 25)
    y = np.sin(2 * X) + 0.1 * rng.standard_normal(25)

    k = SquaredExponentialKernel(
        hyperprior=LogNormalJointPrior([0.0, -0.7], [0.8, 0.8])
    )
    gp = GaussianProcess(k, device="cpu" if args.cpu else "cuda")
    gp.add_data(X, y, err_y=0.1)
    gp.add_data(0.0, 2.0, n=1, err_y=0.05)  # slope constraint at the edge

    fit = gp.optimize_hyperparameters(random_starts=8)
    yhat, std = gp.predict(np.linspace(0, 3, 50))
    print("MAP fit:", dict(zip(gp.model.param_names, np.round(gp.theta.cpu().numpy(), 4))))

    post = gp.sample_hyperparameter_posterior(nsamp=500, burn=300, num_chains=8)
    m, s = gp.predict_MCMC(np.array([0.5, 1.5, 2.5]))
    print("fully-Bayesian prediction:", np.round(m.cpu().numpy(), 3),
          "+-", np.round(s.cpu().numpy(), 3))

    d, dstd = gp.predict(np.array([1.0]), n=1)
    print(f"predicted slope at x=1: {float(d[0]):.3f} (true {2*np.cos(2.0):.3f})")
    return {"gp": gp, "map": fit, "posterior": post, "slope": float(d[0]),
            "slope_std": float(dstd[0])}


if __name__ == "__main__":
    main()
