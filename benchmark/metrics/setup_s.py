"""setup_s: from the start of the process to the first timed request:
imports, the card's context, the kernels' libraries (built on a
checkout's first run), the driver's inputs and one warm-up request."""


def read(ctx):
    return ctx.setup_s
