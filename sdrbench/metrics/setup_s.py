"""setup_s (s, host clock): process start to the first timed chunk."""


def read(ctx):
    return ctx.window.setup_s
