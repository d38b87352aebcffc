"""launch layer of the port (mirrors repro.launch)."""
