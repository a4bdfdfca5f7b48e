"""The conv-formulations table of the port on one NVIDIA GPU, as PERF.md
quotes it.

    python3 tools/conv_formulations.py [--reps N]
    python3 tools/conv_formulations.py library

Runs ``chip_smoke.py``'s ``conv_formulations`` at the bench shapes (512
clients x 32 images, bf16): conv2 14x14 32->64 as library convolution
(``F.conv2d`` with one group per client, in its own layout and between the
layout changes from and to the port's), shift-GEMM (``conv3x3_same``) and
patch GEMM (``conv3x3_patch``, kernel K7), forward and forward + backward;
the stem 28x28 1->32 + relu + pool as library chain and as
``conv_stem_s2d``; the probes ``taploop_conv`` (K8b) and ``batched_gemm``
(K8a) beside ``torch.bmm``. Each formulation is held to the library result
before it is timed (CUDA events, N calls after a warm one, default 20), and
the launch counts of the kernels are checked. Prints the measurement's
lines and then one markdown table.

``library`` instead takes the library convolution of conv2 apart: its
forward (without gradients, and with ``channels_last`` operands prepared
beforehand) and its backward, each timed with CUDA events and then run once
under ``torch.profiler``, with the device time and the launches of its
largest kernels.

The shapes, the inputs and the timer are those of ``chip_smoke.py`` at the
root of the checkout, imported from there. Every line carries the card's
name and power limit. Needs one CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def library(card: str) -> None:
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    C = chip_smoke.NUM_CLIENTS
    gen = torch.Generator(device="cuda").manual_seed(6)
    x, w, g = chip_smoke.patch_inputs(gen, C, chip_smoke.BATCH_SIZE,
                                      chip_smoke.CONV2_SHAPE, torch.bfloat16)
    xl, wl, gl = (chip_smoke.to_library(x), chip_smoke.library_weights(w),
                  chip_smoke.to_library(g))
    xc, wc = (t.to(memory_format=torch.channels_last) for t in (xl, wl))
    xr, wr = xl.detach().requires_grad_(True), wl.detach().requires_grad_(True)
    y = F.conv2d(xr, wr, padding=1, groups=C)

    def forward(a, b):
        with torch.no_grad():
            return F.conv2d(a, b, padding=1, groups=C)

    cases = (("forward", lambda: forward(xl, wl)),
             ("forward, channels_last operands", lambda: forward(xc, wc)),
             ("backward (x and w)", lambda: torch.autograd.grad(
                 y, (xr, wr), gl, retain_graph=True)))
    for name, fn in cases:
        ms = chip_smoke.time_ms(fn, 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                k = kernels.setdefault(ev.name[:80], [0, 0.0])
                k[0] += 1
                k[1] += ev.self_device_time_total
        total = sum(t for _, t in kernels.values()) / 1e3
        print(f"library conv2 {name}: {ms:.3f} ms a call; one call under the "
              f"profiler: {sum(n for n, _ in kernels.values())} launches, "
              f"{total:.3f} ms of device time [{card}]")
        for k, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]:
            print(f"    {t / 1e3:8.3f} ms  x{n:<5d} {k}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: these measurements need one GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    if argv == ["library"]:
        library(card)
        return 0
    reps = 20
    if argv[:1] == ["--reps"] and len(argv) == 2 and argv[1].isdigit():
        reps, argv = int(argv[1]), []
    if argv or reps < 1:
        print(__doc__, file=sys.stderr)
        return 2
    rows, launches = chip_smoke.conv_formulations(card, reps=reps)
    print(f"launches: {launches}")
    print(f"\n| shape | formulation | what | ms | from the library result "
          f"(relative Frobenius) |\n|---|---|---|---|---|")
    for group, name, what, ms, dist in rows:
        print(f"| {group} | {name} | {what} | {ms:.3f} | "
              f"{'—' if dist is None else f'{dist:.2e}'} |")
    print(f"\n[{card}; {reps} calls after a warm one, bf16, "
          f"{chip_smoke.NUM_CLIENTS} clients x {chip_smoke.BATCH_SIZE} "
          f"images]")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except chip_smoke.SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
