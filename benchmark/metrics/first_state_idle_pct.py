"""first_state_idle_pct: the share of the traced window (%) in which the
card is idle inside the program's ``first_deal`` or ``pack_state`` spans
(the first state of a request: Philox words and card sampling in plain
torch, then the packing), an exact intersection of intervals. None
without device operations or without the program's spans."""

from mcbench import program

NAMES = ("first_deal", "pack_state")


def read(ctx):
    return program.idle_pct(ctx.summary, NAMES)
