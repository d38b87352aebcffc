"""Batched distance kernel and the two-pass fused scan."""
