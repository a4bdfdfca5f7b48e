"""Device kernels the traced window launched, per round: the host round
loop's dispatch count."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels or ctx.rounds <= 0:
        return None
    return len(t.kernels) / ctx.rounds
