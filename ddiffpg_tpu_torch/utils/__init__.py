"""Helpers of the port: logging, checkpoints and the weights bundle, maze
coverage and plots, EMA, JAX-package conversion."""
