"""Device ms per round of the library convolutions (cuDNN) and cuDNN's
layout transforms: the models' unfused convolutions."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.rounds <= 0:
        return None
    fam = t.family_ms()
    ms = (fam.get("library convolutions (cuDNN)", 0.0)
          + fam.get("cuDNN layout transforms", 0.0))
    return None if not ms else ms / ctx.rounds
