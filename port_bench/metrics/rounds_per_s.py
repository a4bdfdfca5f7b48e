"""Rounds completed over the whole window: the rounds of every call, over
the seconds from the first dispatch to the last round's metrics on the
host. Host clock."""


def read(ctx):
    return ctx.rounds / ctx.elapsed if ctx.rounds > 0 else None
