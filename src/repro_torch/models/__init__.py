"""Models of the port (dense family only so far)."""
