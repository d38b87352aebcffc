"""Search helpers of the port (the deprecated one-plan shim)."""
