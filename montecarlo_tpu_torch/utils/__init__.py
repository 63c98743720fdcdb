"""Host utilities: table-state checkpoints (``checkpoint.py``) and
profiler traces, the span recorder and the equity CI meter
(``profiling.py``)."""
