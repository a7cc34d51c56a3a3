"""Bijectors, priors and chain diagnostics (config-4 subset)."""
