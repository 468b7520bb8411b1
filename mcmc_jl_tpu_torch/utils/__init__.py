"""Utilities: dtype policy, chain tables, conversion from the JAX package."""
