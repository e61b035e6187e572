"""Command-line drivers of the port."""
