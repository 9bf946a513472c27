"""Training and evaluation engine of the port."""
