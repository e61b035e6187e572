"""Workflow, rule-mining, RISP and eviction layers: copies of the reference package's modules."""
