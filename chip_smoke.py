#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fl_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, one
line each; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: the CUDA kernels from ``fl_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernels vs their plain PyTorch versions on the card, at the bench
   shapes (512 clients x 32 images, C1=32, C2=64; the DP groups of
   SimpleCNN) and on small all-tie and statistical cases, each with its
   tolerance, plus both versions' times;
4. the delta-DP FedAvg round of the 512-client bench configuration
   (bench.py's workload): one warm-up round, then 3 pipelined rounds with
   the kernel launch counts checked;
5. learning check: 10 non-IID clients, 3 rounds, test accuracy > 0.5;
6. the kernel table as one JSON line, the card line, and the final
   ``{"ok": true, ...}`` line.

Needs one CUDA device; imports nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

# bench.py's workload
NUM_CLIENTS = 512
SAMPLES_PER_CLIENT = 64
LOCAL_EPOCHS = 5
BATCH_SIZE = 32
PIPELINED_ROUNDS = 3
EPS_R = 1.0 / 28   # bench.py: epsilon / (rounds + 8) at its 20 rounds
DELTA_R = 1e-5 / 28


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=5):
    """Mean device time of fn() over reps launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bf16_ulp(t):
    """One bf16 ulp at each element's magnitude (8 significant bits)."""
    import torch

    mag = t.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def conv_inputs(gen, C, B, dtype, H=28, C1=32, C2=64, constant=False):
    import torch

    dev = "cuda"
    if constant:
        x = torch.ones((C, B, H, H, 1), device=dev)
    else:
        x = torch.randn((C, B, H, H, 1), generator=gen, device=dev)
    w1 = torch.randn((C, 3, 3, 1, C1), generator=gen, device=dev) * 0.5
    b1 = torch.randn((C, C1), generator=gen, device=dev) * 0.1
    w2 = torch.randn((C, 3, 3, C1, C2), generator=gen, device=dev) * 0.1
    b2 = torch.randn((C, C2), generator=gen, device=dev) * 0.1
    # the entry casts of conv_stack_res: weights to the compute dtype,
    # biases rounded to it and then added in f32
    return (x.to(dtype), w1.to(dtype), b1.to(dtype).float(), w2.to(dtype),
            b2.to(dtype).float())


def check_conv(cb, gen, C, B, dtype, constant=False):
    """K1 and K2 against the plain version on the same inputs. Returns
    (max |pooled| error, max |grad| error, K1 inputs, K2's g and idx)."""
    import torch

    x, w1, b1, w2, b2 = conv_inputs(gen, C, B, dtype, constant=constant)
    pooled, idx = cb.conv_block_fwd_cuda(x, w1, b1, w2, b2)
    p_ref, i_ref = cb.conv_stack_res_fwd_plain(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    pk, pr = pooled.float(), p_ref.float()
    fwd_err = float((pk - pr).abs().max())
    tag = f"{str(dtype)[6:]} C={C} B={B}{' all-ties' if constant else ''}"
    if dtype == torch.float32:
        require(torch.allclose(pk, pr, rtol=1e-5, atol=1e-5),
                f"K1 {tag}: pooled off by {fwd_err} (tol 1e-5)")
    else:
        # one ulp at the larger of the two values; the 1e-5 floor covers
        # sums that straddle zero before relu, where the two f32
        # accumulation orders may round to 0 on one side only
        tol = bf16_ulp(torch.maximum(pk.abs(), pr.abs())) + 1e-5
        over = (pk - pr).abs() > tol
        require(not bool(over.any()),
                f"K1 {tag}: {int(over.sum())} pooled values off by more "
                f"than 1 bf16 ulp, e.g. {pk[over][:4].tolist()} vs "
                f"{pr[over][:4].tolist()}")
    # idx may differ only where the plain window holds a near-tie: the
    # kernel's chosen member within one ulp of the window max
    bad = idx != i_ref
    if bool(bad.any()):
        win = cb.pool2_windows_plain(x, w1, b1, w2, b2)
        chosen = win.gather(-1, idx.long()[..., None])[..., 0]
        near = (chosen - pr).abs() <= (
            bf16_ulp(pr) + 1e-5 if dtype != torch.float32
            else 1e-5 * (1 + pr.abs()))
        require(bool(near[bad].all()),
                f"K1 {tag}: {int(bad.sum())} window indices differ beyond "
                "near-ties")
    # K2 on identical routing: the plain version's idx for both
    g = torch.randn(pooled.shape, generator=gen, device="cuda")
    g = (g * (p_ref > 0)).to(dtype).contiguous()
    got = cb.conv_block_bwd_cuda(g, i_ref, x, w1, b1, w2)
    want = cb.conv_stack_res_bwd_plain(g, i_ref, x, w1, b1, w2)
    torch.cuda.synchronize()
    bwd_err = 0.0
    for name, a, b in zip(("dw1", "db1", "dw2", "db2"), got, want):
        bwd_err = max(bwd_err, float((a - b).abs().max()))
        if dtype == torch.float32:
            require(torch.allclose(a, b, rtol=2e-4, atol=2e-4),
                    f"K2 {tag} {name}: off by {float((a - b).abs().max())} "
                    "(tol 2e-4)")
        else:
            rel = float((a - b).norm() / b.norm().clamp(min=1e-30))
            require(rel <= 1e-2, f"K2 {tag} {name}: relative Frobenius "
                                 f"error {rel} (tol 1e-2)")
    return fwd_err, bwd_err, (x, w1, b1, w2, b2), g, i_ref


def phase_kernels(report):
    import torch

    from fl_tpu_torch.core import prng
    from fl_tpu_torch.fl.privacy import STANDALONE_MIN
    from fl_tpu_torch.ops import conv_block as cb
    from fl_tpu_torch.ops import dp as dpo

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # small cases: both dtypes, random and all-tie images
    for dtype in (torch.float32, torch.bfloat16):
        check_conv(cb, gen, 4, BATCH_SIZE, dtype)
        check_conv(cb, gen, 2, BATCH_SIZE, dtype, constant=True)
    # the bench shapes of the main path (bf16), with both versions' times
    fwd_err, bwd_err, (x, w1, b1, w2, b2), g, idx = check_conv(
        cb, gen, NUM_CLIENTS, BATCH_SIZE, torch.bfloat16)
    report["conv_block_fwd"].update(
        max_abs_err=fwd_err,
        ms=time_ms(lambda: cb.conv_block_fwd_cuda(x, w1, b1, w2, b2)),
        plain_ms=time_ms(lambda: cb.conv_stack_res_fwd_plain(
            x, w1, b1, w2, b2)))
    report["conv_block_bwd"].update(
        max_abs_err=bwd_err,
        ms=time_ms(lambda: cb.conv_block_bwd_cuda(g, idx, x, w1, b1, w2)),
        plain_ms=time_ms(lambda: cb.conv_stack_res_bwd_plain(
            g, idx, x, w1, b1, w2)))
    del x, w1, b1, w2, b2, idx, g

    # K3 at the two DP groups of SimpleCNN at the bench: fc1's kernel and
    # the concatenated small leaves
    C = NUM_CLIENTS
    widths = (7 * 7 * 64 * 128, 421642 - 7 * 7 * 64 * 128)
    assert widths[0] >= STANDALONE_MIN > widths[1]
    rseed = prng.round_seed(prng.root_seed(0), 0)
    groups = []
    for gi, D in enumerate(widths):
        xg = torch.randn((C, D), generator=gen, device="cuda") * 1e-3
        scale = torch.rand((C,), generator=gen, device="cuda")
        seeds = torch.as_tensor(prng.as_int64(prng.client_stream_seeds(
            rseed, C, prng.Stream.DP_NOISE, gi))).cuda()
        groups.append((xg, scale, seeds))
    err = 0.0
    for xg, scale, seeds in groups:
        zero = torch.zeros_like(scale)
        got = dpo.clip_noise_cuda(xg, scale, zero, seeds)
        want = xg * scale[:, None]
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        require(torch.allclose(got, want, rtol=1e-6, atol=0.0),
                "K3 sigma=0: output is not x*scale to 1e-6 relative")
    sig = torch.full((C,), 0.01, device="cuda")
    report["clip_noise"].update(
        max_abs_err=err,
        ms=time_ms(lambda: [dpo.clip_noise_cuda(xg, s, sig, sd)
                            for xg, s, sd in groups]),
        plain_ms=time_ms(lambda: [dpo.clip_noise_plain(xg, s, sig, sd)
                                  for xg, s, sd in groups], reps=2))
    del groups

    # K3 noise statistics at sigma=1: 4 clients x 2^20 per group
    D, Cs = 1 << 20, 4
    ones, zeros = torch.ones(Cs, device="cuda"), torch.zeros((Cs, D),
                                                             device="cuda")
    z = [dpo.clip_noise_cuda(zeros, torch.zeros(Cs, device="cuda"), ones,
                             torch.as_tensor(prng.as_int64(
                                 prng.client_stream_seeds(
                                     rseed, Cs, prng.Stream.DP_NOISE, gi)))
                             .cuda()).double() for gi in (0, 1)]
    flat = z[0].flatten()
    mean, var = float(flat.mean()), float(flat.var())
    tail = float((flat.abs() > 3).double().mean())
    corr_c = float(torch.corrcoef(z[0][:2])[0, 1])
    corr_g = float(torch.corrcoef(torch.stack([z[0][0], z[1][0]]))[0, 1])
    require(abs(mean) <= 3e-3, f"K3 noise mean {mean} (tol 3e-3)")
    require(abs(var - 1) <= 0.01, f"K3 noise variance {var} (tol 1%)")
    require(abs(tail - 0.0027) <= 0.0005,
            f"K3 fraction beyond 3 sigma {tail} (0.27% +- 0.05%)")
    require(abs(corr_c) <= 5e-3 and abs(corr_g) <= 5e-3,
            f"K3 correlation client {corr_c} group {corr_g} (tol 5e-3)")
    print(f"kernels: K1/K2 f32+bf16 (random, all-ties) and bench shapes "
          f"match plain; K3 sigma=0 exact to 1e-6, noise mean={mean:.2e} "
          f"var={var:.5f} tail3={tail:.5f} corr_clients={corr_c:.1e} "
          f"corr_groups={corr_g:.1e}; times (ms, kernel/plain): " + ", ".join(
              f"{k} {v['ms']:.3f}/{v['plain_ms']:.3f}"
              for k, v in report.items()), flush=True)


def bench_engine(card):
    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.data import load_dataset, make_federated_arrays
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    splits = load_dataset("mnist",
                          n_train_synth=NUM_CLIENTS * SAMPLES_PER_CLIENT,
                          n_test_synth=1024)
    arrays = make_federated_arrays(splits, num_clients=NUM_CLIENTS,
                                   strategy="iid",
                                   samples_per_client=SAMPLES_PER_CLIENT,
                                   seed=0)
    cfg = RoundEngineConfig(
        training=FederatedTrainingConfig(
            local_epochs=LOCAL_EPOCHS, batch_size=BATCH_SIZE,
            learning_rate=0.001, optimizer_state_dtype="bfloat16"),
        dp_mode="delta",
        privacy=PrivacyConfig(epsilon=1.0, delta=1e-5, max_grad_norm=1.0),
        epsilon_per_round=EPS_R, delta_per_round=DELTA_R,
        max_clients=NUM_CLIENTS, seed=0)
    model = create_model("simple_cnn", dtype=torch.bfloat16)
    engine = FederatedRoundEngine(model, arrays, cfg, device=DEVICE)
    t0 = time.perf_counter()
    warm = engine.run_round(evaluate=False)
    warm_s = time.perf_counter() - t0
    if DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run_rounds_pipelined(PIPELINED_ROUNDS, evaluate=False)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()

    losses = [warm.train_loss] + [r.train_loss for r in results]
    require(len(results) == PIPELINED_ROUNDS, "pipelined rounds missing")
    require(all(math.isfinite(v) for v in losses), f"losses {losses}")
    steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
    want = {"conv_block_fwd": steps * PIPELINED_ROUNDS,
            "conv_block_bwd": steps * PIPELINED_ROUNDS,
            "clip_noise": 2 * PIPELINED_ROUNDS}
    require(counts == want, f"launch counts {counts}, expected {want}")
    params = engine.global_variables["params"]
    require(all(bool(torch.isfinite(t).all())
                for d in params.values() for t in d.values()),
            "non-finite global parameters")
    require(np.isfinite(engine.last_client_losses).all(),
            "non-finite client losses")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"slice: {NUM_CLIENTS} clients bf16 delta-DP, warm-up round "
          f"{warm_s:.2f}s, {PIPELINED_ROUNDS} pipelined rounds in {dt:.3f}s "
          f"-> {PIPELINED_ROUNDS / dt:.3f} rounds/s, peak memory "
          f"{peak:.2f} GiB, losses {[round(v, 4) for v in losses]}, "
          f"launches {counts}, eps spent "
          f"{engine.budget_tracker.consumed_epsilon:.4f} [{card}]",
          flush=True)
    return counts


def learning_check():
    import torch

    from fl_tpu_torch.data import load_dataset, make_federated_arrays
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    splits = load_dataset("mnist", n_train_synth=4096, n_test_synth=1024)
    arrays = make_federated_arrays(splits, 10, "non_iid", seed=0)
    engine = FederatedRoundEngine(
        create_model("simple_cnn", dtype=torch.bfloat16), arrays,
        RoundEngineConfig(training=FederatedTrainingConfig(local_epochs=2)),
        device=DEVICE, test_images=splits.normalized(splits.test_images),
        test_labels=splits.test_labels)
    accs = [r.test_accuracy for r in engine.run(num_rounds=3)]
    require(accs[-1] > 0.5, f"test accuracy after 3 rounds {accs}")
    print(f"learning: 10 non-IID clients, test accuracy by round "
          f"{[round(a, 4) for a in accs]}", flush=True)


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "fl_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(fl_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke run needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    # 1. device
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build
    from fl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    log = (_build.library_path().parent / "build.log").read_text()
    usage = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"build: {time.perf_counter() - t0:.1f}s -> "
          f"{os.path.relpath(_build.library_path(), ROOT)}; "
          + " | ".join(usage), flush=True)

    # 3. kernels vs plain versions
    report = {
        "conv_block_fwd": {"name": "conv_block_fwd", "route": "cuda",
                           "source": "fl_tpu_torch/csrc/conv_block.cu",
                           "replaces": "fl_tpu/ops/conv_block.py:649"},
        "conv_block_bwd": {"name": "conv_block_bwd", "route": "cuda",
                           "source": "fl_tpu_torch/csrc/conv_block.cu",
                           "replaces": "fl_tpu/ops/conv_block.py:689"},
        "clip_noise": {"name": "clip_noise", "route": "triton",
                       "source": "fl_tpu_torch/ops/dp.py",
                       "replaces": "fl_tpu/ops/dp.py:51"},
    }
    phase_kernels(report)

    # 4. the slice at the bench configuration
    counts = bench_engine(card)

    # 5. learning check
    learning_check()

    # 6. result lines
    for k, entry in report.items():
        entry["launches"] = counts[k]
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in order}
                                  for e in report.values()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
