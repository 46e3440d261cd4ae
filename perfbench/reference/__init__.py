"""The plain references the port's answers are held to. Nothing here
imports the port, JAX or the JAX package."""
