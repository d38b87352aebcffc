"""Streaming fused scan: distance + row mask + top-k in ONE kernel."""
