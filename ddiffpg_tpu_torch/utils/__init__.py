"""Helpers of the port: maze coverage, JAX-package conversion."""
