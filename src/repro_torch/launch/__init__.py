"""Step functions and the trainer: the JAX package's ``launch``."""
