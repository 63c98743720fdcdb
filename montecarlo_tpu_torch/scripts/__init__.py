"""Ports of the reference's scripts: the measurement scripts that build
kernels of their own (``exp_carry_model``, ``debug_kernel_compile``), the
push/fold artifacts' build (``build_pushfold_cr``), and the A/B of this
tree's kernels against another tree's (``ab_engine``)."""
