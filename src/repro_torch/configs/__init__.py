"""Problem configurations (the port's own copies)."""
