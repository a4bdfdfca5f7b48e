"""K2's share of its roofline: the least time of one launch at the cell's
shapes (``kernels/k2.py``) over the mean time of a traced launch, its
partial-sum reduction included, in %."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ms, n = t.kernel_ms("conv_block_bwd")
    if n == 0:
        return None
    ms += t.kernel_ms("reduce_partials_kernel")[0]
    c = ctx.config
    H, W, _ = c["input_shape"]
    C1, C2 = c["conv_channels"]
    flops, nbytes = ctx.load("kernels", "k2").work(
        ctx.workload["data"]["clients"], ctx.workload["training"][
            "batch_size"], H, W, C1, C2)
    bound_ms = 1e3 * max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                         flops / ctx.peaks["bf16_flops_per_s"])
    return 100.0 * bound_ms / (ms / n)
