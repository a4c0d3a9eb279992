"""Set-up: from the process's start to the window's, with the build, the
program's loading, the scene pool and the warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
