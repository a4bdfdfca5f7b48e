"""Device ms per round of the "PyTorch elementwise" kernel family (the
local step's optimizer, casts and norms)."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.rounds <= 0:
        return None
    ms = t.family_ms().get("PyTorch elementwise")
    return None if not ms else ms / ctx.rounds
