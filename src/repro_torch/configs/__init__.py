"""Architecture configs of the model substrate (mirrors repro.configs)."""
