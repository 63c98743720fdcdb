"""The plain reference the benchmark holds the port to.

Plain PyTorch; it imports nothing of the port or of the JAX package.
"""
