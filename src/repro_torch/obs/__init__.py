"""Metrics registry and tracing: copies of the reference package's modules."""
