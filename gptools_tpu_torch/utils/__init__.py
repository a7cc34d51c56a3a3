"""Bijectors, priors, bounds, chain diagnostics and the native diagnostics binding."""
