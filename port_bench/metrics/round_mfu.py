"""The whole round's share of the card's bf16 peak: the model FLOPs of a
round's local training (``flops/<config>.py``: forward and backward once
an example) times the rounds of the traced window, over its seconds and
989 TFLOP/s, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.rounds <= 0:
        return None
    tr = ctx.workload["training"]
    d = ctx.workload["data"]
    steps = max(1, d["samples_per_client"] // tr["batch_size"])
    examples = d["clients"] * tr["local_epochs"] * steps * tr["batch_size"]
    flops = ctx.load("flops", ctx.cell["config"]).train_flops_per_example(
        ctx.config) * examples
    return (100.0 * flops * ctx.rounds / t.window_s
            / ctx.peaks["bf16_flops_per_s"])
