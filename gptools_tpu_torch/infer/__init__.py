"""Samplers of the flagship path: tempered SMC warm-starting ChEES-HMC."""
