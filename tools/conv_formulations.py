"""The conv-formulations table of the port on one NVIDIA GPU, as PERF.md
quotes it.

    python3 tools/conv_formulations.py [--reps N]
    python3 tools/conv_formulations.py library
    python3 tools/conv_formulations.py k7
    python3 tools/conv_formulations.py k8
    python3 tools/conv_formulations.py k8b-parts
    python3 tools/conv_formulations.py outputs FILE
    python3 tools/conv_formulations.py same FILE FILE
    python3 tools/conv_formulations.py sweep
    python3 tools/conv_formulations.py limits

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

``k7`` builds the kernels, prints what nvcc reports for K7's (registers,
spills), runs ``chip_smoke.py``'s checks of K7 against its plain versions and
prints its three directions' times, bounds and library times. ``k8`` does
the same for K8 (``chip_smoke.py``'s probe phase: K8a and K8b against their
plain versions, the routes their plans take, K8b against K7's forward) and
prints both kernels' times, bounds and library times. ``k8b-parts`` times
K8b's TMA kernel at the bench shape whole and with parts of it cut out of
copies of its source (no products, no epilogue, no image loads, only the
image stream), each built by ``nvcc`` under ``fl_tpu_torch/_build/``, 20
calls each: what each part adds to the whole. ``outputs FILE`` saves the
outputs of the K8 launches whose code a K8b change must leave alone (K8a on
each route, K8b in float32 and on its bfloat16 CUDA-core route) on seeded
inputs, and ``same A B`` holds two such files equal bit for bit: run
``outputs`` from two checkouts (this script copied into the other one) to
compare them. ``sweep`` times
the bf16 tensor-core kernels of K7 at the bench shapes over the knobs of
their launch plan (warps a block, tile buffers, blocks a launch; pixels a
stage and slots of the weight gradient), ten calls each. ``limits`` measures
what the card allows those kernels, without them: the ``mma.sync`` rate on
registers alone, a copy and a fill of y's size, and the forward's traffic at
its block geometry with idle clocks in place of the products (a small CUDA
source in this file, built by ``nvcc`` next to the kernel library).

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


def k7(card: str) -> None:
    """K7 alone: what nvcc reports for its kernels, chip_smoke's checks
    against the plain versions, and the three directions' times."""
    from fl_tpu_torch.ops import _build

    _build.load()
    log = (_build.library_path().parent / "build.log").read_text()
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "patch" in ln:
            print("build: " + " | ".join(t.strip() for t in lines[i:i + 4]))
    report = chip_smoke.kernel_report()
    chip_smoke.phase_conv_patch(report)
    for name in ("conv3x3_patch_gemm", "conv3x3_patch_wgrad"):
        print(f"{name}: {report[name]} [{card}]")


def k8(card: str) -> None:
    """K8 alone: what nvcc reports for its kernels, chip_smoke's checks
    against the plain versions, and both probes' times."""
    from fl_tpu_torch.ops import _build

    _build.load()
    log = (_build.library_path().parent / "build.log").read_text()
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and (
                "taploop" in ln or "gemm" in ln and "patch" not in ln):
            print("build: " + " | ".join(t.strip() for t in lines[i:i + 4]))
    report = chip_smoke.kernel_report()
    chip_smoke.phase_conv_probe(report)
    for name in ("probe_batched_gemm", "probe_taploop_conv"):
        print(f"{name}: {report[name]} [{card}]")


# Cuts of K8b's TMA kernel (csrc/conv_probe.cu), each (source text, what
# takes its place); a cut whose text is no longer in the source fails.
_K8B_NO_PRODUCTS = (
    "      for (int j = 0; j < SPC; ++j) wgmma_m64k16<NT>(d, a[j], desc[j]);",
    "      for (int j = 0; j < SPC; ++j) d[0][0] += __uint_as_float(a[j][0] ^ a[j][3] ^ "
    "(uint32_t)desc[j]);")
_K8B_NO_GATHERS = (
    "      for (int j = 0; j < SPC; ++j) ldmatrix_x4(a[j], row + (chunk[j] ^ flip));",
    "      for (int j = 0; j < SPC; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = "
    "row + (chunk[j] ^ flip);")
_K8B_NO_LOADS = (
    "          mbar_arrive_expect_tx(&full[s], tx);\n"
    "          for (int kc = 0; kc < IC; ++kc)\n"
    "            tma_load_4d(s_x + (size_t)s * stage_bytes + kc * box_bytes, &map_x, &full[s],\n"
    "                        kc * KC, -1, -1, q.c * B + ring.b_lo + u - ring.first);",
    "          mbar_arrive(&full[s]);")
_K8B_EPILOGUE = ("    // one rounding; the warpgroup's tile goes out by one TMA store",
                 "      bulk_commit();\n    }\n  }\n")
K8B_PARTS = (("whole", ()), ("no products", (_K8B_NO_PRODUCTS,)),
             ("no epilogue (no y)", ("epilogue",)),
             ("no image loads", (_K8B_NO_LOADS,)),
             ("image stream only", (_K8B_NO_PRODUCTS, _K8B_NO_GATHERS,
                                    "epilogue")))


def _k8b_cut(text: str, cuts) -> str:
    start = text.index("taploop_tma_wgmma_kernel(const __grid_constant__")
    head, text = text[:start], text[start:]
    for cut in cuts:
        if cut == "epilogue":
            i0 = text.index(_K8B_EPILOGUE[0])
            i1 = text.index(_K8B_EPILOGUE[1], i0) + len(_K8B_EPILOGUE[1])
            text = (text[:i0] + "    if (acc[0][0][0] == 12345.f) my_out[0] = 1;\n  }\n"
                    + text[i1:])
        else:
            if cut[0] not in text:
                raise chip_smoke.SmokeFailure(
                    f"k8b-parts: the cut {cut[0][:60]!r} is no longer in "
                    "csrc/conv_probe.cu")
            text = text.replace(cut[0], cut[1])
    return head + text


def k8b_parts(card: str, reps: int = 20) -> None:
    """K8b's TMA kernel at the bench shape, whole and with parts cut out of
    copies of its source, each built by nvcc and timed (CUDA events, `reps`
    calls after a warm one); the whole one is held to the plain version."""
    import ctypes
    import subprocess

    from fl_tpu_torch.ops import _build
    from fl_tpu_torch.ops import conv_probe as probe

    src = _build.CSRC_DIR
    text = (src / "conv_probe.cu").read_text()
    procs = []
    for n, (name, cuts) in enumerate(K8B_PARTS):
        d = _build.BUILD_DIR / "k8b_parts" / str(n)
        d.mkdir(parents=True, exist_ok=True)
        (d / "common.cuh").write_text((src / "common.cuh").read_text())
        (d / "conv_probe.cu").write_text(_k8b_cut(text, cuts))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               str(d / "lib.so"), str(d / "conv_probe.cu"), "-ldl"]
        procs.append((name, d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    C, B = chip_smoke.NUM_CLIENTS, chip_smoke.BATCH_SIZE
    H, W, I, O = chip_smoke.CONV2_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(5)
    x, w, _ = chip_smoke.patch_inputs(gen, C, B, chip_smoke.CONV2_SHAPE,
                                      torch.bfloat16)
    plan = probe.taploop_launch_plan(torch.bfloat16, C, B, H, W, I, O)
    chip_smoke.require(plan.route == "tma", f"k8b-parts: plan {plan}")
    y = torch.empty((C, B, H, W, O), dtype=torch.bfloat16, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for name, d, proc in procs:
        _, err = proc.communicate()
        chip_smoke.require(proc.returncode == 0,
                           f"k8b-parts: nvcc failed on {name}: {err[-2000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        p_, i_ = ctypes.c_void_p, ctypes.c_int
        lib.fl_taploop_conv.argtypes = [i_, i_] + [p_] * 3 + [i_] * 12 + [p_]

        def run():
            rc = lib.fl_taploop_conv(
                1, 1, x.data_ptr(), w.data_ptr(), y.data_ptr(), C, B, H, W, I,
                O, plan.band, plan.items_per_block, plan.threads, plan.stages,
                plan.blocks, plan.items_per_block, stream)
            chip_smoke.require(rc == 0, f"k8b-parts: {name} returned {rc}")

        ms = chip_smoke.time_ms(run, reps)
        if name == "whole":
            chip_smoke.check_rounded("K8b", "k8b-parts", y,
                                     probe.taploop_conv_plain(x, w),
                                     torch.bfloat16)
        print(f"k8b-parts: {name}: {ms:.3f} ms ({plan.stages} stages x "
              f"{plan.blocks} blocks) [{card}]", flush=True)


def outputs(path: str) -> None:
    """The K8 outputs a change to K8b's bfloat16 TMA route must leave bit
    for bit as they were, on inputs drawn from a fixed seed."""
    from fl_tpu_torch.ops import conv_probe as probe

    gen = torch.Generator(device="cuda").manual_seed(12)
    got = {}
    for dtype in (torch.float32, torch.bfloat16):
        for C, M, K, N in ((4, 8192, 288, 64), (3, 70, 50, 37)):
            a = torch.randn((C, M, K), generator=gen, device="cuda").to(dtype)
            b = torch.randn((C, K, N), generator=gen, device="cuda").to(dtype)
            got[f"K8a {dtype} {C}x{M}x{K}x{N}"] = probe.batched_gemm_cuda(a, b)
    shapes = ((torch.float32, (16, 32) + chip_smoke.CONV2_SHAPE),
              (torch.float32, (3, 3, 5, 7, 20, 12)),
              (torch.bfloat16, (16, 32, 14, 14, 4, 128)),
              (torch.bfloat16, (3, 3, 5, 7, 20, 12)))
    for dtype, (C, B, *shape) in shapes:
        x, w, _ = chip_smoke.patch_inputs(gen, C, B, tuple(shape), dtype)
        got[f"K8b {dtype} {C}x{B}x{shape}"] = probe.taploop_conv_cuda(x, w)
    torch.save({k: v.cpu() for k, v in got.items()}, path)
    print(f"outputs: {len(got)} tensors to {path}")


def same(path_a: str, path_b: str) -> int:
    a, b = torch.load(path_a), torch.load(path_b)
    differ = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
    print(f"same: {len(a) - len(differ)} of {len(a)} outputs bit for bit "
          f"equal" + (f"; differ: {differ}" if differ else ""))
    return 1 if differ or set(a) != set(b) else 0


def sweep(card: str, reps: int) -> None:
    """The bf16 tensor-core kernels of K7 at the bench shapes over the
    launch plan's knobs: warps a block and tile buffers of the patch GEMM
    (forward, input gradient, stem forward), pixels a stage and blocks of
    the weight gradient. The first row of each group is the plan as it
    stands."""
    from fl_tpu_torch.ops import conv_patch as cp

    C, B = chip_smoke.NUM_CLIENTS, chip_smoke.BATCH_SIZE
    gen = torch.Generator(device="cuda").manual_seed(4)
    x, w, g = chip_smoke.patch_inputs(gen, C, B, chip_smoke.CONV2_SHAPE,
                                      torch.bfloat16)
    xs, ws, gs = chip_smoke.patch_inputs(gen, C, B, chip_smoke.S2D_STEM_SHAPE,
                                         torch.bfloat16)
    w2, wd = w.reshape(C, 288, 64), cp.dgrad_weights(w)
    ws2 = ws.reshape(C, 36, 128)
    cases = (("forward", lambda: cp.patch_gemm_cuda(x, w2)),
             ("input gradient", lambda: cp.patch_gemm_cuda(g, wd)),
             ("stem forward", lambda: cp.patch_gemm_cuda(xs, ws2)))
    first_fit = cp._first_fit
    try:
        for warps in (None, 8, 4):
            for stages in ((None,) if warps is None else (2, 1)):
                if warps is not None:
                    cp._first_fit = (
                        lambda kernel, dtype, W, I, O, cands, pick=(
                            warps * cp.TC_WARP_ROWS, warps * 32, stages):
                        (pick, cp.smem_bytes(kernel, dtype, W, I, O, *pick)))
                for blocks in (512, 1024, 2048, 4096):
                    cp.TC_GEMM_BLOCKS = blocks
                    ms = [chip_smoke.time_ms(fn, reps) for _, fn in cases]
                    print(f"sweep gemm warps={warps} stages={stages} "
                          f"blocks={blocks}: " + ", ".join(
                              f"{n} {t:.3f} ms" for (n, _), t in zip(cases, ms))
                          + f" [{card}]", flush=True)
        cp.TC_GEMM_BLOCKS = 512
        wcases = (("weight gradient", lambda: cp.patch_wgrad_cuda(x, g)),
                  ("stem weight gradient", lambda: cp.patch_wgrad_cuda(xs, gs)))
        for rows in (None, 128, 64, 256):
            for stages in ((None,) if rows is None else (2, 1)):
                cp._first_fit = first_fit if rows is None else (
                    lambda kernel, dtype, W, I, O, cands, r=rows, st=stages:
                    ((r, cands[0][1], st),
                     cp.smem_bytes(kernel, dtype, W, I, O, r, cands[0][1], st)))
                for blocks in (512, 1024, 2048, 4096):
                    cp.TC_WGRAD_BLOCKS = blocks
                    ms = [chip_smoke.time_ms(fn, reps) for _, fn in wcases]
                    print(f"sweep wgrad rows={rows} stages={stages} "
                          f"blocks={blocks}: " + ", ".join(
                              f"{n} {t:.3f} ms" for (n, _), t in zip(wcases, ms))
                          + f" [{card}]", flush=True)
    finally:
        cp._first_fit = first_fit


LIMITS_CU = r"""
// Two yardsticks for K7's tensor-core kernels, no convolution in them.
#include <cuda_runtime.h>
#include <stdint.h>

// mma.sync m16n8k16 bf16 on registers alone: NACC independent sums a warp
template <int NACC>
__global__ void mma_loop(float* out, int iters) {
  float c[NACC][4];
  for (int i = 0; i < NACC; ++i)
    for (int v = 0; v < 4; ++v) c[i][v] = 0.f;
  uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u}, b0 = 5u + threadIdx.x, b1 = 6u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int i = 0; i < NACC; ++i)
    for (int v = 0; v < 4; ++v) s += c[i][v];
  if (s == 1234.5f) out[0] = s;
}

// The forward's traffic and block geometry without its products: a block of
// 256 threads walks tiles of 256 rows, reads 64 B a row (16 KB a tile)
// through shared memory, idles `spin` clocks in place of the products, and
// writes 128 B a row (32 KB a tile) in 16-byte pieces; 100 KB of shared
// memory a block keeps two blocks on an SM.
__global__ void __launch_bounds__(256)
traffic(const uint4* __restrict__ x, uint4* __restrict__ y, int tiles_per_block, int n_tiles,
        int spin) {
  extern __shared__ uint4 s[];
  const int c = blockIdx.y, tile0 = blockIdx.x * tiles_per_block;
  const uint4* xc = x + (size_t)c * n_tiles * 1024;
  uint4* yc = y + (size_t)c * n_tiles * 2048;
  for (int t = 0; t < tiles_per_block && tile0 + t < n_tiles; ++t) {
    const size_t tile = tile0 + t;
    for (int i = 0; i < 4; ++i)
      s[i * 256 + threadIdx.x] = xc[tile * 1024 + i * 256 + threadIdx.x];
    __syncthreads();
    const uint4 v = s[(threadIdx.x * 7) & 1023];
    const long long t0 = clock64();
    while (clock64() - t0 < spin) {}
    for (int i = 0; i < 8; ++i) yc[tile * 2048 + i * 256 + threadIdx.x] = v;
    __syncthreads();
  }
}

static float timed(void (*launch)(void*), void* arg, int reps) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0), cudaEventCreate(&e1);
  launch(arg);
  cudaEventRecord(e0);
  for (int r = 0; r < reps; ++r) launch(arg);
  cudaEventRecord(e1), cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms / reps;
}

struct MmaArgs { float* out; int warps, iters; };
static void launch_mma(void* p) {
  MmaArgs* a = (MmaArgs*)p;
  mma_loop<16><<<132, a->warps * 32>>>(a->out, a->iters);
}
extern "C" float limits_mma_ms(int warps, int iters) {
  MmaArgs a;
  cudaMalloc(&a.out, 4), a.warps = warps, a.iters = iters;
  const float ms = timed(launch_mma, &a, 3);
  cudaFree(a.out);
  return ms;
}

struct TrafficArgs { const uint4* x; uint4* y; int C, n_tiles, tpb, spin; };
static void launch_traffic(void* p) {
  TrafficArgs* a = (TrafficArgs*)p;
  dim3 grid((a->n_tiles + a->tpb - 1) / a->tpb, a->C);
  traffic<<<grid, 256, 102400>>>(a->x, a->y, a->tpb, a->n_tiles, a->spin);
}
extern "C" float limits_traffic_ms(const void* x, void* y, int C, int n_tiles, int tpb,
                                   int spin) {
  cudaFuncSetAttribute(traffic, cudaFuncAttributeMaxDynamicSharedMemorySize, 102400);
  TrafficArgs a = {(const uint4*)x, (uint4*)y, C, n_tiles, tpb, spin};
  return timed(launch_traffic, &a, 10);
}
"""


def limits(card: str) -> None:
    """What the card allows K7's tensor-core kernels, measured without them:
    the rate of ``mma.sync`` m16n8k16 on registers alone; a device-to-device
    copy and a fill of y's size; and the forward's traffic at its block
    geometry (two blocks of 256 threads an SM, tiles of 256 rows) with idle
    clocks in place of the products."""
    import ctypes
    import subprocess

    from fl_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "limits"
    out.mkdir(parents=True, exist_ok=True)
    (out / "limits.cu").write_text(LIMITS_CU)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(out / "limits.so"), str(out / "limits.cu")], check=True)
    lib = ctypes.CDLL(str(out / "limits.so"))
    lib.limits_mma_ms.restype = lib.limits_traffic_ms.restype = ctypes.c_float
    lib.limits_mma_ms.argtypes = [ctypes.c_int] * 2
    lib.limits_traffic_ms.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    torch.zeros(1, device="cuda")

    iters = 20000
    for warps in (4, 8, 16):
        ms = lib.limits_mma_ms(warps, iters)
        tflops = 132 * warps * iters * 16 * 4096 / ms / 1e9
        print(f"limits: mma.sync m16n8k16 bf16, registers only, {warps} warps "
              f"an SM: {tflops:.1f} TFLOP/s [{card}]")

    C, B = chip_smoke.NUM_CLIENTS, chip_smoke.BATCH_SIZE
    n_tiles = 25                       # of 256 rows: 32 images x 14 x 14
    x = torch.zeros((C, n_tiles * 256, 32), dtype=torch.bfloat16, device="cuda")
    y = torch.zeros((C, n_tiles * 256, 64), dtype=torch.bfloat16, device="cuda")
    y2 = torch.empty_like(y)
    mb = y.numel() * 2 / 1e6
    ms = chip_smoke.time_ms(lambda: y2.copy_(y), 10)
    print(f"limits: copy of {mb:.0f} MB (read and written): {ms:.3f} ms, "
          f"{2 * mb / ms / 1e3:.2f} TB/s [{card}]")
    ms = chip_smoke.time_ms(lambda: y.zero_(), 10)
    print(f"limits: fill of {mb:.0f} MB: {ms:.3f} ms, {mb / ms / 1e3:.2f} TB/s "
          f"[{card}]")
    del y2
    for tpb in (4, 25):
        for spin in (0, 3000, 6000, 9000):
            ms = lib.limits_traffic_ms(x.data_ptr(), y.data_ptr(), C, n_tiles,
                                       tpb, spin)
            print(f"limits: the forward's traffic ({x.numel() * 2 / 1e6:.0f} MB "
                  f"read, {mb:.0f} MB written), two blocks an SM, {tpb} tiles a "
                  f"block, {spin} idle clocks a tile: {ms:.3f} ms [{card}]")


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
    if argv == ["k7"]:
        k7(card)
        return 0
    if argv == ["k8"]:
        k8(card)
        return 0
    if argv == ["k8b-parts"]:
        k8b_parts(card)
        return 0
    if argv[:1] == ["outputs"] and len(argv) == 2:
        outputs(argv[1])
        return 0
    if argv[:1] == ["same"] and len(argv) == 3:
        return same(argv[1], argv[2])
    if argv == ["sweep"]:
        sweep(card, 10)
        return 0
    if argv == ["limits"]:
        limits(card)
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
