"""Host utilities: table-state checkpoints (``checkpoint.py``) and
profiler traces and the equity CI meter (``profiling.py``)."""
