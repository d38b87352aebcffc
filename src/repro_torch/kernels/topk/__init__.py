"""Top-k kernel over a score matrix."""
