"""host_path_idle_pct: the share of the traced window (%) in which the
card is idle inside the program's spans of the sweep's host path:
``sweep.masks`` (the heroes' dead cards and suit masks, and their copies
up), ``launch.sweep`` (the wrapper's work up to K2's launch) and
``sweep.read`` (the counts' read-back and the equities' arithmetic). None
without device operations or without the program's spans."""

from mcbench import program

NAMES = ("sweep.masks", "launch.sweep", "sweep.read")


def read(ctx):
    return program.idle_pct(ctx.summary, NAMES)
