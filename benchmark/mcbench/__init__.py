"""The benchmark harness of montecarlo_tpu_torch (see core.py)."""
