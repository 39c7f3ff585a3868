"""Host-side utilities: weight conversion from the JAX package."""
