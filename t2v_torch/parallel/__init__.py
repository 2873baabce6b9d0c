"""Training steps of the port (single device)."""
