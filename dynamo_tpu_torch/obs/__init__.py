"""Observability contracts the port's worker shares with the JAX fleet."""
