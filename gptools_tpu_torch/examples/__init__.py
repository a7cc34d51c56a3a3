"""The reference's entry points, run through the port on the card.

Counterparts of the JAX package's ``examples/`` scripts, each a module with
``main(argv=None)`` that prints what its counterpart prints, with the same
flags and defaults:

    python -m gptools_tpu_torch.examples.run_config {1..5} [--plot] [--cpu] [--mesh [N]]
    python -m gptools_tpu_torch.examples.sine_derivative_constraint [--cpu]
    python -m gptools_tpu_torch.examples.multimodal_pt [--cpu] [--chains 16] ...

They run on the card unless ``--cpu`` is given; without a card and without
``--cpu`` they raise. ``main`` returns the run's results for callers in
Python (tests, ``chip_smoke.py``).
"""
