"""Set-up: from process start to the start of the measured window (log
generation, kernel builds, the program's construction and warm-up)."""


def read(ctx):
    return ctx.setup_s
