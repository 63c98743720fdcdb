"""What every driver shares.

A driver (``drivers/<name>.py``) is a module with ``MAIN_KERNEL``, a part
of the name of the kernel its requests exist for, and a ``Driver`` class
built as ``Driver(config, traffic, device, seed)`` that subclasses
``Base`` and gives:

- ``_run(key)``: one request of the traffic keyed by ``key`` (an index,
  or "warmup"), through the program, until its answer is on the host;
- ``request(i)``: request ``i`` of the window: its work counted from the
  answer (a dict of counts), keeping what the check needs;
- ``check(control=False)``: after the window, [(name, value, limit)] of
  each number compared with the plain reference; with ``control`` the
  reference's control stands in the program's place.
"""

from __future__ import annotations

import torch

from mcbench import trace


class Base:
    def __init__(self, device, seed):
        self.device, self.seed = device, seed
        self.span = trace.Spans()
        self.n_answered = 0

    def warmup(self):
        """One request of the cell's own shapes, before the window."""
        self._run("warmup")

    def release(self):
        """Free what the program held after the window."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def extra_work(self):
        """Work no answer reports, known after ``check``."""
        return {}
