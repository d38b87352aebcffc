"""Serve steps of the model substrate (mirrors repro.train)."""
