"""Process start to the window's start: imports, kernel builds or loads,
weights from the seed, the speaker voices, the server, the warm-up
requests and the lead-in load."""


def read(ctx):
    return ctx.setup_s
