"""Counters and gauges (copy of the JAX package's metrics API)."""
