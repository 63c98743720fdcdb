"""Ports of the reference's measurement scripts (``scripts/``) that build
kernels of their own: ``exp_carry_model`` and ``debug_kernel_compile``."""
