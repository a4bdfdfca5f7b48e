"""Set-up: from the start of the process to the start of the window
(inputs, the engine, kernel builds and compiles on a checkout's first run,
the check's rounds that warm every shape). Host clock."""


def read(ctx):
    return ctx.setup_s
