"""Seconds from the process's start to the window's opening: imports, the
trials, the program's build, the weights and the warm-up steps."""


def read(ctx):
    return ctx.setup_s
