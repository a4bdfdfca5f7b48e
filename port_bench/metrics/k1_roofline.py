"""K1's share of its roofline: the least time of one launch at the cell's
shapes (``kernels/k1.py``: max of bytes / 3.35 TB/s and FLOPs / 989
TFLOP/s) over the mean time of the traced launches, in %."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ms, n = t.kernel_ms("conv_block_fwd")
    if n == 0:
        return None
    c = ctx.config
    H, W, _ = c["input_shape"]
    C1, C2 = c["conv_channels"]
    flops, nbytes = ctx.load("kernels", "k1").work(
        ctx.workload["data"]["clients"], ctx.workload["training"][
            "batch_size"], H, W, C1, C2)
    bound_ms = 1e3 * max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                         flops / ctx.peaks["bf16_flops_per_s"])
    return 100.0 * bound_ms / (ms / n)
