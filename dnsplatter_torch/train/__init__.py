"""Training (this slice: checkpoint loading only)."""
