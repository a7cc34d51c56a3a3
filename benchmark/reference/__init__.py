"""Plain float64 references of the benchmark's posteriors (PyTorch only)."""
