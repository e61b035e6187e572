"""Single-flight election and aggregate stats: copies of the reference package's modules."""
