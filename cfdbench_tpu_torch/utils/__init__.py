"""Device helpers and the JAX weight import."""
