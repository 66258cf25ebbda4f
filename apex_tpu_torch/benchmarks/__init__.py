"""Benchmarks of the port (``benchmarks/`` of the JAX package)."""
