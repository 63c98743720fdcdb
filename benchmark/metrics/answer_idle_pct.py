"""answer_idle_pct: the share of the traced window (%) in which the card
is idle inside the program's spans that bring a request's answer to the
host: ``meters.read`` (the rows' read-back, with the wait for the last
launch), ``meters.stats`` (the host's arithmetic) and ``selfplay.read``
(the two counts). None without device operations or without the
program's spans."""

from mcbench import program

NAMES = ("meters.read", "meters.stats", "selfplay.read")


def read(ctx):
    return program.idle_pct(ctx.summary, NAMES)
