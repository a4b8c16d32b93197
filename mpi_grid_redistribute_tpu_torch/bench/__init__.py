"""Benchmark state generation and sizing shared with the JAX package's
bench configs."""
