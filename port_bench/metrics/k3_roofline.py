"""K3's share of its roofline over the traced window: the bytes its
releases need (``kernels/k3.py``) at 3.35 TB/s over the time of every
traced K3 launch, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.rounds <= 0:
        return None
    ms, n = t.kernel_ms("clip_noise_kernel")
    if n == 0:
        return None
    nbytes = ctx.load("kernels", "k3").bytes_per_round(ctx.config,
                                                       ctx.workload)
    bound_ms = 1e3 * nbytes * ctx.rounds / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * bound_ms / ms
