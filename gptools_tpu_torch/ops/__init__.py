"""Kernel metadata, fused covariance build, evidence and its CUDA kernel."""
