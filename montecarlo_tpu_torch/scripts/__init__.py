"""Ports of the reference's scripts: the measurement scripts that build
kernels of their own (``exp_carry_model``, ``debug_kernel_compile``), the
push/fold artifacts' build (``build_pushfold_cr``), the A/B of this
tree's kernels against another tree's (``ab_engine``), and the operation
and byte count of a table-engine step (``count_engine_ops``)."""
