"""serve layer of the port (mirrors repro.serve)."""
