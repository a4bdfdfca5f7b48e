"""Hand-written Hopper kernels, each beside its plain PyTorch version.

A CUDA tensor launches the kernel (or the launcher raises); a CPU tensor
takes the plain version. Each launcher adds one to its count in
:func:`launch_counts` where it launches, and nowhere else. ``flatten`` and
``topk`` hold no kernel: they are plain PyTorch, as the reference's are XLA.
"""

from fl_tpu_torch.ops import conv_block, conv_patch, conv_probe, dp, quantize

_COUNTS = (conv_block.LAUNCHES, dp.LAUNCHES, quantize.LAUNCHES,
           conv_patch.LAUNCHES, conv_probe.LAUNCHES)
# the launches of K7, K8a, K8b and the fused conv kernels by route: reset
# with the counts, not among them
_ROUTE_COUNTS = (conv_patch.ROUTE_LAUNCHES, conv_probe.ROUTE_LAUNCHES,
                 conv_probe.TAPLOOP_ROUTE_LAUNCHES, conv_block.ROUTE_LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS + _ROUTE_COUNTS:
        for k in counts:
            counts[k] = 0
