"""Training data loaders of the port."""
