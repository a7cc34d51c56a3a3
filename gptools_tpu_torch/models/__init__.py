"""Observation container and the GP model's batched surface."""
