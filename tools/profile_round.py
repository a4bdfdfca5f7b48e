"""Measurements of the port on one NVIDIA GPU that PERF.md quotes.

    python3 tools/profile_round.py sweep
    python3 tools/profile_round.py parts
    python3 tools/profile_round.py profile [--out DIR] [residual|true|false|
        up-int8|up-topk|up-powersgd|down-bf16|down-int8|down-int8+up-topk|
        client-dp|v1|v2|v2-f32|v3|v4|v5|v6|v7|dp-sgd-microbatch|
        dp-sgd-ghost|dp-ftrl|distributed-fused|distributed-per-client ...]

``sweep`` times the four conv kernels at the bench shapes (512 clients x 32
images, bf16, C1=32, C2=64) for each thread count per block, CUDA events
over 5 launches after a warm one, in the order 1024 ... 128 ... 1024 so
that drift shows (in bf16 these are the tensor-core kernels,
``conv_block_fwd_tc_kernel`` and its three siblings).

``parts`` splits the four conv kernels' bf16 time (512 clients x 32 images,
28x28, C1=32) into the part that grows with C2 (conv2 and its gradients on
the tensor cores, w2 and the outputs) and the part that does not (the image,
the stem and its backward on the CUDA cores, the syncs): it times each kernel
at C2 = 16, 32, 48, 64 as ``sweep`` does and fits time = a + b * C2 by least
squares; a is the C2-free part, a / time(64) its share at the bench width.

``profile`` runs the 512-client bf16 delta-DP round of ``bench.py``'s
workload for each named value of ``fused_conv_block``, or with
``fused_conv_block="residual"`` and one of ``chip_smoke.py``'s compressed
configurations (``up-*``: uplink int8, top-k 1%, PowerSGD rank 4;
``down-*``: downlink bf16, int8; ``down-int8+up-topk``), or
``client-dp``, the same round under ``dp_mode="client_dp"`` as
``chip_smoke.py``'s central-DP phase runs it, or ``v1`` .. ``v4``, the
cells of its ``phase_fl_variants`` (``chip_smoke.variant_engine``), or
``v2-f32``, V2 with its parameters stored in f32, or ``v5`` .. ``v7``,
FedDyn, q-FFL and PEFT as its ``phase_engine_api`` runs them
(``chip_smoke.api_engine``), or the other DP mechanisms' cells of its
``phase_dp_mechanisms`` (``chip_smoke.mechanism_cells``: DP-SGD's
microbatch fold on ``"residual"`` and ghost norms on ``False``, DP-FTRL,
distributed DP with fused and per-client noise): one warm-up round,
then 3 pipelined rounds under ``torch.profiler``, and prints the device
time per round grouped by kernel family, the launches per round, the busy
share of the profiled window, rounds/s without the profiler (3 pipelined
rounds before it) and the peak memory; with ``--out DIR`` the kernels by
their own names go to ``DIR/profile_<value>.txt``.

The bench configuration, the conv inputs and the timer are those of
``chip_smoke.py`` at the root of the checkout, imported from there. Every
line carries the card's name and power limit. Needs one CUDA device.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

ROUNDS = 3

# kernel-name fragments -> family, first match wins
FAMILIES = (
    ("conv_block_bwd_kernel", "K2 conv_block_bwd_kernel"),
    ("conv_block_bwd_tc_kernel", "K2 conv_block_bwd_tc_kernel"),
    ("conv_block_fwd_kernel", "K1 conv_block_fwd_kernel"),
    ("conv_block_fwd_tc_kernel", "K1 conv_block_fwd_tc_kernel"),
    ("conv_stack_bwd_kernel", "K4 conv_stack_bwd_kernel"),
    ("conv_stack_bwd_tc_kernel", "K4 conv_stack_bwd_tc_kernel"),
    ("conv_stack_fwd_kernel", "K4 conv_stack_fwd_kernel"),
    ("conv_stack_fwd_tc_kernel", "K4 conv_stack_fwd_tc_kernel"),
    ("reduce_partials_kernel", "reduce_partials_kernel"),
    ("clip_noise_kernel", "K3 clip_noise_kernel"),
    ("max_pool", "library max pool fwd/bwd"),
    ("conv_depthwise2d", "library conv1 (PyTorch's depthwise kernels)"),
    ("nchwToNhwc", "cuDNN layout transforms (NCHW <-> NHWC)"),
    ("nhwcToNchw", "cuDNN layout transforms (NCHW <-> NHWC)"),
    ("tensorTransform", "cuDNN layout transforms (NCHW <-> NHWC)"),
    ("cudnn", "library conv2 (cuDNN)"),
    ("nvjet", "fc1/fc2 GEMMs (torch.bmm, cuBLAS)"),
    ("gemm", "fc1/fc2 GEMMs (torch.bmm, cuBLAS)"),
    ("cutlass", "fc1/fc2 GEMMs (torch.bmm, cuBLAS)"),
    ("reduce_kernel", "PyTorch reductions"),
    ("mbtopk", "torch.topk (radix select)"),
    ("Sort", "torch.sort (robust aggregation)"),
    ("roll_cuda_kernel", "torch.roll (secure aggregation's masks)"),
    ("_scatter_gather", "scatter and gather"),
    ("Memcpy", "copies and casts"),
    ("copy_kernel", "copies and casts"),
    ("poisson", "torch.poisson (Skellam draws)"),
    ("distribution", "random draws (rand, randn)"),
    ("elementwise", "PyTorch elementwise"),
)


def sweep(card: str) -> None:
    from fl_tpu_torch.ops import conv_block as cb

    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    x, w1, b1, w2, b2 = chip_smoke.conv_inputs(
        gen, chip_smoke.NUM_CLIENTS, chip_smoke.BATCH_SIZE, dt)
    pooled, idx = cb.conv_block_fwd_cuda(x, w1, b1, w2, b2)
    g_raw = torch.randn(pooled.shape, generator=gen, device="cuda").to(dt)
    g = (g_raw * (pooled > 0)).to(dt).contiguous()
    calls = {
        "conv_block_fwd": lambda t: cb.conv_block_fwd_cuda(
            x, w1, b1, w2, b2, threads=t),
        "conv_block_bwd": lambda t: cb.conv_block_bwd_cuda(
            g, idx, x, w1, b1, w2, threads=t),
        "conv_stack_fwd": lambda t: cb.conv_stack_fwd_cuda(
            x, w1, b1, w2, b2, threads=t),
        "conv_stack_bwd": lambda t: cb.conv_stack_bwd_cuda(
            g_raw, x, w1, b1, w2, b2, threads=t),
    }
    for threads in (1024, 768, 512, 256, 128, 256, 512, 768, 1024):
        times = {key: chip_smoke.time_ms(lambda: fn(threads))
                 for key, fn in calls.items()}
        print(f"sweep threads={threads}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items()) + f" [{card}]",
            flush=True)


def parts(card: str) -> None:
    from fl_tpu_torch.ops import conv_block as cb

    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    widths = (16, 32, 48, 64)
    times = {}
    for C2 in widths:
        args = chip_smoke.conv_inputs(gen, chip_smoke.NUM_CLIENTS,
                                      chip_smoke.BATCH_SIZE, dt, C2=C2)
        x, w1, b1, w2, b2 = args
        pooled, idx = cb.conv_block_fwd_cuda(*args)
        g_raw = torch.randn(pooled.shape, generator=gen, device="cuda").to(dt)
        g = (g_raw * (pooled > 0)).to(dt).contiguous()
        times[C2] = {
            "conv_block_fwd": chip_smoke.time_ms(
                lambda: cb.conv_block_fwd_cuda(*args)),
            "conv_block_bwd": chip_smoke.time_ms(
                lambda: cb.conv_block_bwd_cuda(g, idx, x, w1, b1, w2)),
            "conv_stack_fwd": chip_smoke.time_ms(
                lambda: cb.conv_stack_fwd_cuda(*args)),
            "conv_stack_bwd": chip_smoke.time_ms(
                lambda: cb.conv_stack_bwd_cuda(g_raw, *args)),
        }
        del args, x, w1, b1, w2, b2, pooled, idx, g_raw, g
        torch.cuda.empty_cache()
    n, mx = len(widths), sum(widths) / len(widths)
    sxx = sum((c - mx) ** 2 for c in widths)
    for kernel in cb.LAUNCHES:
        ys = [times[c][kernel] for c in widths]
        my = sum(ys) / n
        b = sum((c - mx) * (y - my) for c, y in zip(widths, ys)) / sxx
        a = my - b * mx
        print(f"parts {kernel} bf16: " + ", ".join(
            f"C2={c} {y:.3f} ms" for c, y in zip(widths, ys))
            + f"; fit {a:.3f} + {b:.4f} * C2 ms: the C2-free part (image, "
            f"stem, syncs) {a:.3f} ms = {a / times[64][kernel]:.3f} of the "
            f"time at C2=64 [{card}]", flush=True)


def _family(name: str) -> str:
    for fragment, family in FAMILIES:
        if fragment in name:
            return family
    return "everything else"


def _device_us(ev) -> float:
    """A kernel event's device time (the attribute was renamed)."""
    if hasattr(ev, "self_device_time_total"):
        return ev.self_device_time_total
    return ev.self_cuda_time_total


def profile(card: str, name: str, label: str, make_engine,
            out_dir: Optional[Path]) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    engine = make_engine()
    engine.run_round(evaluate=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.run_rounds_pipelined(ROUNDS, evaluate=False)
    rate = ROUNDS / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_rounds_pipelined(ROUNDS, evaluate=False)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    us, calls = defaultdict(float), defaultdict(int)
    by_name = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            fam = _family(ev.name)
            us[fam] += _device_us(ev)
            calls[fam] += 1
            by_name[ev.name] += _device_us(ev)
    if out_dir is not None:
        # the kernels by their own names, for checking the grouping above
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"profile_{name}.txt").write_text("".join(
            f"{t / 1e3 / ROUNDS:10.2f} ms/round  {_family(n):44s} {n}\n"
            for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])))
    total = sum(us.values())
    if total == 0:
        raise RuntimeError("the profiler recorded no device time")
    print(f"profile {label}: {rate:.3f} rounds/s "
          "without "
          f"the profiler, peak memory {peak:.2f} GiB; under it {ROUNDS} "
          f"rounds in {window:.3f}s, device kernel time "
          f"{total / 1e3 / ROUNDS:.1f} ms/round, busy share "
          f"{total / 1e6 / window:.4f} [{card}]", flush=True)
    for fam in sorted(us, key=us.get, reverse=True):
        print(f"  {fam}: {us[fam] / 1e3 / ROUNDS:.1f} ms/round, "
              f"{100 * us[fam] / total:.1f}%, "
              f"{calls[fam] / ROUNDS:.0f} launches/round", flush=True)
    del engine
    torch.cuda.empty_cache()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: these measurements need one GPU",
              file=sys.stderr)
        return 1
    def bench(fused, compression):
        label = f"fused_conv_block={fused!r}" + "".join(
            f" {k}={v!r}" for k, v in compression.items())
        return label, lambda: chip_smoke.make_bench_engine(fused,
                                                           **compression)

    modes = {"residual": bench("residual", {}), "true": bench(True, {}),
             "false": bench(False, {})}
    # chip_smoke.COMPRESSED_ENGINES, in its order
    modes.update(zip(("up-int8", "up-topk", "up-powersgd", "down-bf16",
                      "down-int8", "down-int8+up-topk"),
                     (bench("residual", c)
                      for c in chip_smoke.COMPRESSED_ENGINES)))
    modes["client-dp"] = ("fused_conv_block='residual' dp_mode='client_dp'",
                          chip_smoke.central_dp_engine)
    for v in chip_smoke.VARIANTS:
        modes[v.lower()] = (f"{v} ({chip_smoke.VARIANT_LABELS[v]})",
                            lambda v=v: chip_smoke.variant_engine(v))
    # V2 with its parameters stored in f32: what bf16 storage costs
    modes["v2-f32"] = ("V2 with f32 parameter storage", lambda:
                       chip_smoke.variant_engine("V2",
                                                 param_storage_dtype=None))
    for v in chip_smoke.API_CELLS:
        modes[v.lower()] = (f"{v} ({chip_smoke.API_LABELS[v]})",
                            lambda v=v: chip_smoke.api_engine(v))
    for name, cell in chip_smoke.mechanism_cells().items():
        modes[name] = (name, lambda cell=cell:
                       chip_smoke.mechanism_engine(**cell))
    out_dir = None
    if argv[1:2] == ["--out"] and len(argv) > 2:
        out_dir, argv = Path(argv[2]), argv[:1] + argv[3:]
    if not argv or argv[0] not in ("sweep", "parts", "profile") or (
            argv[0] != "profile" and len(argv) > 1) or any(
            a not in modes for a in argv[1:]):
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    if argv[0] == "sweep":
        sweep(card)
    elif argv[0] == "parts":
        parts(card)
    else:
        for name in argv[1:] or ["residual", "true", "false"]:
            profile(card, name, *modes[name], out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
