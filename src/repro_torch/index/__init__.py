"""index layer of the port (mirrors repro.index)."""
