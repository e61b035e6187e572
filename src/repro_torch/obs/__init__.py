"""Metrics registry, tracing and structured logging: copies of the reference
package's modules."""
