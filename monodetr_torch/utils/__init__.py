"""Logging and seeding helpers (a copy of the JAX package's utils)."""
