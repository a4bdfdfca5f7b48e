"""The allocator's peak over the window (``max_memory_allocated`` after
``reset_peak_memory_stats`` at the end of set-up), in GiB: how many
clients fit on the card."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
