"""K3 (DP clip + noise) and K6 (int8 stochastic quantizer) on one NVIDIA
GPU: what their compiled code does per element, and their times beside
another checkout's.

    python3 tools/rng_kernels.py isa [--parent DIR] [--out DIR]
    python3 tools/rng_kernels.py time [--parent DIR] [--reps N]
    python3 tools/rng_kernels.py sweep [--reps N]

``isa`` compiles each kernel at the bench shapes (K3 at fc1's group, 512 x
401,408; K6 stochastic on 216,006,656 values), takes Triton's SASS of it
(``asm["sass"]``) and prints the instruction count split into integer,
float, MUFU, conversion, global load, global store, uniform-datapath and
other instructions, each divided by the elements a thread handles (the
kernels have no loops, so this is the count each element costs): once for
the whole code ("static") and once for the path an element runs ("run",
without the branch of sinf/cosf that only arguments of 105615 and more
take). With ``--parent DIR`` it does the
same for the kernels of another checkout at DIR (for instance a ``git
archive`` of the parent commit), loaded from its files under other module
names. It also prints the lines of Triton's ``triton/language/random.py``
that key Philox; with ``--out DIR`` that file and each kernel's SASS go to
DIR.

``time`` times both DP groups of a round (512 x 401,408 and 512 x 20,234)
through K3 and the 216,006,656-value stochastic quantization through K6,
CUDA events over ``--reps`` launches after a warm one, in the order parent,
this checkout, this checkout, parent, with each bytes bound (3.35 TB/s).

It then reads the SM clock and the power draw from ``nvidia-smi`` while
K3 runs back to back for 2 s, for each of the two checkouts.

``sweep`` times this checkout's two kernels at 2, 4 and 8 warps a program.

Every line carries the card's name and power limit. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

C = chip_smoke.NUM_CLIENTS
WIDTHS = (7 * 7 * 64 * 128, chip_smoke.N_PARAMS - 7 * 7 * 64 * 128)

# SASS opcode (its part before the first '.') -> class
SASS_CLASSES = {
    "integer": ("IMAD IADD3 IADD LOP3 LOP SHF SHL SHR ISETP IMNMX IABS LEA "
                "PRMT SEL POPC FLO BREV BMSK IMUL ISCADD VIADD VIMNMX "
                "IDP").split(),
    "float": "FFMA FMUL FADD FSETP FMNMX FSEL FCHK FSET FSWZADD".split(),
    "mufu": ["MUFU"],
    "convert": "I2F F2I F2F I2I I2FP F2IP FRND".split(),
    "load": "LDG LD".split(),
    "store": "STG ST".split(),
}
def _class_of(op: str) -> str:
    base = op.split(".")[0]
    if base.startswith("U") and base not in ("UNKNOWN",):
        return "uniform"
    for cls, ops in SASS_CLASSES.items():
        if base in ops:
            return cls
    return "other"


def _sass_lines(sass: str):
    """(opcode, text) of each instruction, and ("label", name) of each
    label, in order, from Triton's SASS ("--:-:0:-:1<TAB>OPCODE ...": the
    control codes first)."""
    for line in sass.splitlines():
        label = re.match(r"\s*(\.?L\w+|LBB\w+):", line)
        if label:
            yield "label", label.group(1)
            continue
        m = re.match(r"\s*[0-9a-f-]{2}:[-0-9]:[-0-9]:[-Y]:[0-9a-f]+\s+(.*)",
                     line)
        if not m:
            continue
        body = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(1).strip())
        op = re.match(r"[A-Z0-9_.]+", body)
        if op:
            yield op.group(0), body


def sass_mix(sass: str):
    """(static mix, mix of the path an element runs): the second leaves out
    each region that a predicated branch jumps over and that uses local
    memory, the argument reduction of sinf/cosf for |x| >= 105615 (the
    kernels' arguments lie in [0, 2 pi))."""
    lines = list(_sass_lines(sass))
    labels = {name: i for i, (op, name) in enumerate(lines) if op == "label"}
    static, run = Counter(), Counter()
    skip_to = -1
    for i, (op, body) in enumerate(lines):
        if op == "label":
            continue
        static[_class_of(op)] += 1
        if i < skip_to:
            continue
        target = re.search(r"BRA\s+(\.?L\w+|LBB\w+)", body)
        if target and labels.get(target.group(1), -1) > i:
            end = labels[target.group(1)]
            if any(o.startswith(("LDL", "STL")) for o, _ in lines[i:end]):
                skip_to = end
        run[_class_of(op)] += 1
    return static, run


def compiled_of(jit_fn):
    """The kernels a Triton JITFunction has compiled in this process."""
    return [k for entry in jit_fn.device_caches.values()
            for k in entry[0].values()]


def load_ops(root: Path, tag: str):
    """(dp, quantize) modules of the checkout at root, under fresh names."""
    mods = []
    for name in ("dp", "quantize"):
        path = root / "fl_tpu_torch" / "ops" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"{tag}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append(mod)
    return mods


def k3_inputs(D, sigma=0.01):
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((C, D), generator=gen, device="cuda") * 1e-3
    scale = torch.rand((C,), generator=gen, device="cuda")
    seeds = torch.randint(-2 ** 62, 2 ** 62, (C,), generator=gen,
                          device="cuda")
    return x, scale, torch.full((C,), sigma, device="cuda"), seeds


def k6_input():
    gen = torch.Generator(device="cuda").manual_seed(2)
    return torch.randn((chip_smoke.quantize_width(),), generator=gen,
                       device="cuda") * 1e-3


def isa(card: str, parent, out) -> None:
    import triton
    import triton.language.random as tr

    src = inspect.getsource(tr)
    if out:
        out.mkdir(parents=True, exist_ok=True)
        (out / "triton_random.py").write_text(src)
    print(f"triton {triton.__version__}; triton/language/random.py keys "
          "Philox as:")
    for line in src.splitlines():
        if re.search(r"seed_(hi|lo) =|def (randint4x|philox)\b|"
                     r"N_ROUNDS_DEFAULT =|PHILOX_(KEY|ROUND)_[AB] =|"
                     r"return philox\(|_0 = ", line):
            print("   " + line.rstrip())

    checkouts = [("change", ROOT)] + ([("parent", parent)] if parent else [])
    for tag, root in checkouts:
        dp, qz = load_ops(root, tag)
        x, scale, sigma, seeds = k3_inputs(WIDTHS[0])
        dp.clip_noise_cuda(x, scale, sigma, seeds)
        q = qz.quantize_int8_blocks_cuda(k6_input(), 5)
        torch.cuda.synchronize()
        del x, q
        per_program = {"clip_noise_kernel": (4 * dp.BQ if hasattr(dp, "BQ")
                                             else dp.BLOCK),
                       "quantize_int8_kernel": qz.CHUNK}
        for jit_fn in (dp._compiled, qz._compiled):
            for kernel in compiled_of(jit_fn):
                warps = kernel.metadata.num_warps
                key = next(k for k in per_program
                           if k in kernel.metadata.name)
                per_thread = per_program[key] / (32 * warps)
                sass = kernel.asm["sass"]
                if out:
                    (out / f"{tag}_{key}.sass").write_text(sass)
                print(f"isa {tag} {key} ({warps} warps, {per_thread:g} "
                      f"elements a thread) [{card}]", flush=True)
                for what, mix in zip(("static", "run"), sass_mix(sass)):
                    report_mix(what, mix, per_thread)
                print("    MUFU "
                      f"{dict(Counter(re.findall(r'MUFU[.](\w+)', sass)))}")


def report_mix(what: str, mix: Counter, per_thread: float) -> None:
    total = sum(mix.values())
    print(f"  {what}: {total} instructions, {total / per_thread:.1f} an "
          "element: " + ", ".join(
              f"{c} {mix[c] / per_thread:.1f}"
              for c in ("integer", "float", "mufu", "convert", "load",
                        "store", "uniform", "other")), flush=True)


def _k3_all(dp, groups):
    return [dp.clip_noise_cuda(x, s, sg, sd) for x, s, sg, sd in groups]


def time_both(card: str, parent, reps: int) -> None:
    mods = [("change", *load_ops(ROOT, "change"))]
    if parent:
        p = ("parent", *load_ops(parent, "parent"))
        mods = [p, mods[0], mods[0], p]
    groups = [k3_inputs(D) for D in WIDTHS]
    x6 = k6_input()
    n3 = sum(g[0].numel() for g in groups)
    b3, _ = chip_smoke.bound(8 * n3 + 2 * 16 * C, 0)
    b6, _ = chip_smoke.bound(5 * x6.numel() + 4 * (x6.numel() // 2048), 0)
    for tag, dp, qz in mods:
        t3 = chip_smoke.time_ms(lambda: _k3_all(dp, groups), reps)
        t6 = chip_smoke.time_ms(
            lambda: qz.quantize_int8_blocks_cuda(x6, 5), reps)
        print(f"time {tag}: K3 both groups {t3:.4f} ms (bound {b3:.4f}, "
              f"{b3 / t3:.0%} of it); K6 {t6:.4f} ms (bound {b6:.4f}, "
              f"{b6 / t6:.0%}) [{card}]", flush=True)
    for tag, dp, qz in mods[:2]:
        sm, watts = clocks_under(lambda: _k3_all(dp, groups))
        print(f"clocks {tag} K3, launched back to back for 2 s: SM clock "
              f"{sm} MHz, power {watts} W (nvidia-smi every 100 ms: min, "
              f"median, max) [{card}]", flush=True)


def clocks_under(fn, seconds=2.0):
    """(SM clock, power draw) as (min, median, max) of nvidia-smi's
    samples while fn() is launched back to back for `seconds`."""
    import statistics
    import time

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    rows = [[float(v) for v in line.split(",")]
            for line in out.splitlines() if line.strip()]
    rows = rows[2:-1] or rows           # drop the ramp at both ends
    return tuple(tuple(f(r[i] for r in rows) for f in
                       (min, statistics.median, max)) for i in (0, 1))


def sweep(card: str, reps: int) -> None:
    from fl_tpu_torch.ops import dp, quantize as qz

    groups = [k3_inputs(D) for D in WIDTHS]
    x6 = k6_input()
    for warps in (2, 4, 8, 4, 2):
        dp.NUM_WARPS = qz.NUM_WARPS = warps
        t3 = chip_smoke.time_ms(lambda: _k3_all(dp, groups), reps)
        t6 = chip_smoke.time_ms(
            lambda: qz.quantize_int8_blocks_cuda(x6, 5), reps)
        print(f"sweep {warps} warps: K3 {t3:.4f} ms, K6 {t6:.4f} ms "
              f"[{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("isa", "time", "sweep"))
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: these measurements need one GPU",
              file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    if args.what == "isa":
        isa(card, args.parent, args.out)
    elif args.what == "time":
        time_both(card, args.parent, args.reps)
    else:
        sweep(card, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
