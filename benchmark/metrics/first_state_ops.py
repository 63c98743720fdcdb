"""first_state_ops: the CUDA runtime calls that enqueue device work
(``program.ENQUEUE``: kernel launches, asynchronous copies and sets)
starting inside the program's ``first_deal`` or ``pack_state`` spans,
over the requests the traced window answered. None without device
operations or without the program's spans."""

from mcbench import program

NAMES = ("first_deal", "pack_state")


def read(ctx):
    return program.enqueues_per_request(ctx.summary, NAMES,
                                        len(ctx.latencies_s))
