"""The plain reference the program's outputs are held to: plain torch and
numpy, importing nothing of the program, of JAX or of the JAX package."""
