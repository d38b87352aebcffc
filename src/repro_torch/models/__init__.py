"""Model substrate of the port (mirrors repro.models): the dense family."""
