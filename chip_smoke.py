#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fl_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, one
line each; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: the CUDA kernels from ``fl_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernels vs their plain PyTorch versions on the card, each with its
   tolerance, on small cases (f32 and bf16, random and all-tie images) and
   at the bench shapes (512 clients x 32 images, C1=32, C2=64; the DP groups
   of SimpleCNN; one round's client deltas for the int8 quantizer), with
   the kernel's, the plain version's and a library yardstick's time:
   K1/K2 (``conv_stack_res``), K4 forward and backward (``conv_stack``,
   also held to K1/K2 on the same inputs bit for bit in both dtypes: K4's
   forward to K1, K4's backward to K2 fed K1's residuals; each kernel to
   itself across two runs), at the bench widths and at H=16, C1=12, C2=20
   with 5 images a client (the bf16 route's padded channels, a partial
   block); every launch's route (bf16 on the tensor cores, f32 on the CUDA
   cores) counted and checked, the launch plans' shared-memory bytes held
   to the library's own count for all four kernels, K5
   (``conv_stack_packed``,
   bit-equal to ``conv_stack`` per client for P = 1, 2, 4, 3), K3 (DP
   clip + noise: exact at sigma = 0; its noise equal to the numpy
   Philox4x32-10 oracle of ``tests/philox_oracle.py`` through its counter
   map at ragged widths, to 1e-5; held by moments, 3-sigma tail, a
   Kolmogorov–Smirnov test and correlations across clients, groups, the
   cosine and sine of one radius and the two pairs of one Philox call) and
   K6 (int8 block quantizer: deterministic mode exact, stochastic mode
   equal to the oracle's decisions on 5 blocks and held by floor/ceil,
   bias, P(ceil) per decile and the correlation of one call's quarters); K7
   (``conv3x3_patch``: patch GEMM forward and input gradient, weight
   gradient; f32 on the CUDA cores, bf16 on the tensor cores, the route
   each dtype took printed and checked, the weight gradient repeated bit
   for bit, the launch plan's shared-memory bytes held to the library's own
   count) and K8 (``batched_gemm``, ``taploop_conv``) in f32 and bf16 on
   small shapes, ragged ones among them, and at the conv2 and stem shapes
   of the bench (K8a: the route each dtype and shape took, TMA, staged or
   the CUDA cores, printed and checked against its launch plan and the
   plan's shared memory against the library's count; ``batched_gemm`` on a
   bf16 view that does not start on a 16-byte boundary; K8b: the route each
   dtype and shape took, TMA or the CUDA cores, checked against its plan
   and the plan's shared memory against the library's count, and the bf16
   TMA route at the bench shape also held to K7's forward, with the largest
   gap in bf16 ulps and the share of bit-equal outputs), with ``F.conv2d``
   (groups = clients), its backward and ``torch.bmm`` as library
   yardsticks;
4. the delta-DP FedAvg round of the 512-client bench configuration
   (bench.py's workload) with ``fused_conv_block="residual"``: one warm-up
   round, then 3 pipelined rounds with the kernel launch counts and their
   routes (the tensor cores) checked;
5. the same configuration with ``fused_conv_block=True`` (K4), 3 pipelined
   rounds, and with ``fused_conv_block=False`` (cuDNN convolutions through
   autograd, no hand-written conv kernel), 2 pipelined rounds, launch
   counts checked; ``F.max_pool2d``'s backward is checked to route ties to
   the first window member; then the compression phase: the
   ``"residual"`` configuration with uplink int8, top-k (1%) and PowerSGD
   (rank 4), downlink bf16 and int8, and downlink int8 + uplink top-k, each
   one warm-up and 2 pipelined rounds with K1/K2/K3's launches as on the
   uncompressed path, finite results and a non-zero error-feedback norm
   where an uplink is on; the uplink round trips on the card held to the
   port's CPU functions on 8 rows of a real (512, 421,760) matrix (int8 bit
   for bit, top-k the same kept set, PowerSGD within rtol 1e-5 and 1e-6 of
   a row's largest value) and timed; the real global model through the
   wire codecs (lz4 on the native codec, quantization, top-k) and back;
   then the entry points ``conv_stack_packed`` and ``quantize_int8`` driven
   once at full width with their counts read; then the central-DP phase
   (``phase_central_dp``): the ``"residual"`` configuration under
   ``dp_mode="client_dp"`` (DP-FedAvg of McMahan et al. 2018: q = 0.1,
   so m̄ = 51.2, z = 1, C = 1, (ε, δ) = (8, 1e-5)), one warm-up and 3
   pipelined rounds under the RDP accountant with K1/K2 launched 10 times a
   round on the tensor cores and K3 never, each round's participants the
   pure Poisson draw of the engine's numpy stream, σ = z·C/m̄ and ε by
   round equal to a fresh RDP accountant's (one ``central_dp client_dp``
   line with rounds/s, peak memory and the host's accounting ms a
   dispatch); the PLD gate's step budget at first use (its host seconds)
   and one round (a ``central_dp pld`` line); adaptive clipping with the
   default σ_b = m̄/20 over 3 ``run_round`` rounds, with
   ``run_rounds_pipelined`` refused (the clip norm and the noisy clipped
   fraction by round on a ``central_dp adaptive`` line); the update-canary
   audit with 16 canaries over 10 rounds, its ε lower bound at or below
   the certified ε (``central_dp audit``); ``clip_client_deltas`` and the
   fixed-m̄ masked mean, literal and folded into the weights, on a (512 x
   SimpleCNN) stacked tree against f64 on the host, and
   ``central_noise_tree`` on the model's leaves by mean, variance, a
   Kolmogorov–Smirnov test and the correlation across leaves
   (``central_dp functions``);
   then the slice's local-training options and first server-side features
   (``phase_fl_variants``), each cell the ``"residual"`` bf16 round at 512
   clients, one warm-up and 2 pipelined rounds with K1/K2 launched 10
   times a round on the tensor cores (masked epochs included) and K3 twice
   a round where delta DP is on, finite losses and parameters, rounds/s
   and peak memory on one ``fl_variants`` line each: V1 SGD (momentum 0.9)
   + FedNova on epoch budgets 1 + (i mod 5) of 5 under delta DP at ε_r = 8
   (at the bench's 1/28 SGD overflows, see ``V1_EPS_R``); V2 AdamW + FedProx
   + bf16 parameter storage + coordinate median under the bench's delta
   DP; V3 SCAFFOLD (SGD lr 0.05, no DP) with |c| by round; V4 FedAdam on
   the server + secure aggregation under the bench's delta DP; then on one
   round's (512, 421,760) delta matrix with 10% of the clients out: the
   trimmed mean (k = 25), the median and multi-Krum (f = 1, m = 1 and 8)
   timed and held to f64 on the host (4096 sampled columns; Krum's whole
   selection against f64 scores), Krum's Gram product unchanged by the
   TF32 switch, the secure sum against the plain weighted sum at full
   width, and the stochastic bf16 rounding by its bias over 64 seeds on
   fc1's kernel and on the card equal to the CPU bit for bit (a
   ``fl_variants functions`` line); then the server side's second half and
   the engine's other entry points (``phase_engine_api``), each cell the
   ``"residual"`` bf16 round at 512 clients, one warm-up and 2 pipelined
   rounds, one ``engine_api`` line each with rounds/s, peak memory and the
   launches a round: V5 FedDyn (α = 0.01, Adam, no DP; the pipelined rounds
   leave every 8th client out, whose g_i keep their bits while every other
   g_i moves; h and g finite), V6 q-FFL (q = 1, Adam, no DP; K1 11 times a
   round, the 11th F_k(θ̂) over each client's 64 images; the pre-losses
   finite), V7 PEFT (the conv layers trainable) under the bench's delta DP
   (K1, K2, K3), and a 10-client, 2-round engine without DP whose fc1 and
   fc2 keep their initial bits; on V5's engine ``evaluate_federated`` (one
   K1 launch) and ``evaluate_personalized`` at 512 clients, timed, a
   checkpoint saved and restored into a fresh engine whose next round
   equals the uninterrupted engine's bit for bit (params, h, g), and one
   ``profile_round`` whose Chrome trace must exist; V8, the bench round
   through ``run_rounds_fused(3)`` against ``run_rounds_pipelined(3)`` on
   two engines in the same run, with the host syncs each made (torch's
   synchronizing-call warnings; the fused runner must make exactly one,
   its device→host copy of the stacked metrics) and both rates; then the
   other DP mechanisms (``phase_dp_mechanisms``): K1/K2 (and K4) at DP-SGD's
   microbatch fold, 512 clients x 16 examples as (8192, 1), against their
   plain versions in bf16 and f32 and timed; each cell the 512-client
   bf16 bench round, one warm-up and 2 pipelined rounds, one
   ``dp_mechanisms`` line with rounds/s, peak memory, the launches a round
   and ε by round beside a fresh accountant's: dp_sgd microbatch on
   ``"residual"`` (q = 0.5, z = 2, C = 1, m = 16: K1 30 and K2 20 times a
   round, one K1 a step for the metrics' forward and one K1 / K2 a chunk;
   K3 once a leaf a step, 80 a round, for the noise keyed by client),
   dp_sgd ghost on ``False`` (no conv kernel; K3 as for the microbatch
   form), the PLD step budget under
   dp_sgd on a 1e-3 grid with its host seconds, dp_ftrl on ``"residual"``
   (z = 1, T = 8, cohorts of m̄ = 51 in rotation, ε charged once) and its
   checkpoint restored into a fresh engine whose next round is bit-equal,
   distributed DP with fused and with per-client Skellam noise (z = 1,
   q = 0.1, 14 bits); then on the card: ghost against microbatch (f32,
   rtol 2e-4 / atol 2e-5, the microbatch also on K1/K2), the DP-FTRL tree's
   node reuse bit for bit, ``torch.poisson``'s Skellam draws by mean and
   variance at the bench plan's per-client and aggregate rates, the modular
   sum against the int64 sum mod 2^32 (a ``dp_mechanisms functions``
   line);
   then the CIFAR-10 slice (``phase_cifar``): K3 at CIFAR10CNN's five
   leaf groups (512 clients; the conv5, conv6, fc1 and fc2 kernels alone,
   the batch statistics and small params together) against its plain
   version, exact at sigma = 0, its noise against the Philox oracle at the
   ragged last group and by its moments, timed with its bound; the main
   path, the bench's round with CIFAR10CNN(norm="batch") in bf16 and the
   on-device augmentation (512 clients x 64 synthetic images, delta DP at
   the bench's budget): one warm-up and 2 pipelined rounds, K3 launched 5
   times a round and nothing else, finite losses, ``batch_stats`` finite
   and moved (the count of noised running variances below zero printed),
   rounds/s, the device span a round and peak memory (a ``cifar main
   path`` line); DP-SGD ghost on CIFAR10CNN(norm="group") at
   ``scripts/dp_sgd_cifar_eps15.py``'s shape (24 clients x 4,096 samples,
   batch 256, SGD lr 0.05, C = 1, z RDP-calibrated to ε = 1.5 over 30
   rounds; K3 once a leaf a step for the noise and nothing else), ε by
   round equal to a fresh RDP accountant's; and a learning
   check, 10 IID clients, weak delta DP, 3 rounds, test accuracy on the
   running statistics > 0.5;
   then the rest of the model zoo (``phase_zoo``), each at the bench's
   training options: K3 at FederatedResNet's nine leaf groups (128
   clients; the eight layer2 / layer3 conv kernels alone, the rest with
   the batch statistics) against its plain version as for CIFAR; the main
   path, ``get_model_for_dataset("cifar100")`` (the ResNet at 100 classes,
   published widths) in bf16 with the augmentation, 128 clients x 64
   synthetic CIFAR images under the bench's delta DP: one warm-up and 2
   pipelined rounds, K3 launched 9 times a round and nothing else, the 30
   ``batch_stats`` leaves finite; the ViT with rank-4 LoRA adapters under
   ``lora_trainable_patterns()``, 512 clients, delta DP (K3 once a round),
   then a round without DP after which every frozen leaf keeps its bits,
   and ``merge_lora`` of its global params, whose forward equals the
   unmerged one (f32 to 1e-4 of the largest logit, bf16 within 3e-2
   relative); LightweightMobileNet at width 0.5, 512 clients, delta DP,
   one warm-up and one round; each with rounds/s, the device span a round
   (CUDA events) and peak memory on a ``zoo`` line; ``benchmark_models``
   (every model's eval forward, one client x 32 images, CUDA events); and
   two learning checks, 10 IID clients x 512, weak delta DP, 3 rounds: the
   ResNet's test accuracy on the running statistics > 0.5, the ViT's
   training loss falling; then the client mesh (``phase_mesh``): the
   512-client ``"residual"`` bench round unsharded, then on a one-rank
   NCCL mesh (``make_mesh()``), 3 pipelined rounds after a warm-up each,
   the mesh's weights equal to the unsharded ones bit for bit, its
   per-round collectives two all-reduces (the 1.69 MB packed delta, the
   packed metrics), K1/K2 10 and K3 2 times a round; then two gloo ranks
   sharing the one card (``core.mesh.spawn``), 256 clients each, held to
   the unsharded weights within 1e-5 of each leaf's largest weight (+
   1e-6; the share within rtol 1e-5 / atol 1e-6 element by element
   printed), the warm-up round's loss within 1e-5 relative and the later
   ones (of a model the bench's noise has destroyed, 1e7–1e9) within
   1e-4, each rank's launches, rounds/s and peak memory printed (``mesh``
   lines); then the other engines (``phase_engines``) at the bench's 512
   clients, model and training: IFCA at k = 4 without DP (a warm-up and
   3 rounds, K1 = k assignment forwards + 10 and K2 = 10 a round; the last
   cluster set to a copy of the one before it is adopted by nobody and
   passes a round bit for bit; a checkpoint's next round bit for bit),
   FedBuff with a 64-client buffer and max_staleness 8 (a warm-up and 4
   server steps, K1 = K2 = 10 a step, the staleness histogram and the
   cancellations; a checkpoint's next step bit for bit, timeline
   included), Ditto at λ = 0.1 beside the delta-DP bench engine (a
   warm-up and 3 (round, step) pairs, K1 = K2 = 20 and K3 = 2 a pair;
   ``evaluate_personal``, K1 twice; the engine's and the 0.86 GB of
   personal models' checkpoints, the next pair bit for bit), each with its
   rate and peak memory on an ``engines`` line; on two gloo ranks sharing
   the card IFCA's first round (the assignments equal, each leaf within
   1e-5 of its largest weight, two all-reduces) and the bench round with
   Ditto's step from the unsharded run's θ_g (the round within phase_mesh's
   tolerance, the step's personal models at every 32nd client within it,
   its metrics within 1e-4), every rank launching K1 and K2 (and K3 in
   the bench round); the world-2 checkpoint of the engine and the personal
   models restored at world 1 bit for bit (sha256 of every rank's rows);
   and learning checks on 16 clients x 256 with label-permuted halves:
   IFCA warm-started reaches pure populations, Ditto's personal models
   beat the global one, FedBuff raises the test accuracy; then the
   hierarchical, decentralized, FedDF and HPO engines
   (``phase_topologies``) at the same width, without DP: K1 at FedDF's
   teacher shape (512 clients x 256 proxy images) and student shape (1 x
   256) and K2 at the student's, bf16, held to their plain versions (the
   plain forward at 512 clients in chunks of 64; the errors join the
   kernel table's); HierFAVG at E = 8, τ = 2 (a warm-up and 3 rounds, K1
   = K2 = 10 a round, the edge divergence 0.0 after each sync); D-PSGD
   on the ring (a warm-up and 2 rounds, the consensus distance printed)
   and one round at W = 11ᵀ/C, every client held to one no-DP round of
   ``FederatedRoundEngine`` from the same init within 1e-5 of each leaf's
   largest weight; FedDF at the reference's defaults (64 Adam steps x 256
   of 2,048 synthetic proxy images; a warm-up and one round, K1 = 10 +
   65 teacher + 66 student forwards and K2 = 10 + 64 a round, the probe
   KL shrinking in both rounds); HPO over learning rates (1e-4, 1e-3,
   1e-2) with a rung after round 0 at η = 2 (the rung round at 1,536
   trainer rows kills one trial, the survivors bit for bit their
   pre-compaction slots; 2 rounds at G = 2, K1 = 11 and K2 = 10 a round);
   each with rounds/s and peak memory on a ``topologies`` line; and each
   engine's first round on two gloo ranks sharing the card within 1e-5
   of each leaf's largest weight of the single-process round (FedDF with
   8 SGD distill steps), every rank's launches and collectives printed;
   then the quick start, the validators, the attacks, analytics and
   vertical FL (``phase_validation``); then the deployment round
   (``phase_deployment``): 8 ``FederatedTrainer`` threads (the client
   FSM at SimpleCNN's full width, non-IID over 8,192 synthetic images,
   one epoch at batch 32, delta DP at (3, 1e-5) over 3 rounds) against
   the port's ``FederatedLearningServicer`` over localhost gRPC
   (``FedAvgAggregator`` on the card, the DP-widened validator; the run
   fails naming ``grpcio`` where it does not import): K3 launches = 8 x
   3, each round's global model within 1e-6 (of a leaf's largest value)
   of the float64 sample-weighted mean of the decoded uploads, the wire
   bit-equal, ε 1.0 a round a client, finite losses; one client's delta
   through ``clip_and_noise_tree`` bit-equal to ``use_pallas=False`` at
   σ = 0 with the row clipped and std/σ within 2% at the real budget;
   rounds/s on the wall clock, the median ms of a client's train / DP /
   compress / serialize stages and of the aggregation, peak memory, K3's
   and the plain version's ms at (1, 421,642); then
   ``FederatedLearningSimulation(backend="grpc")`` for one round; then
   the secure deployment (``phase_secure_deployment``; a line saying it
   did not run where ``cryptography`` does not import): the same 8 FSMs
   under Bonawitz secure aggregation at delta DP ε_r 20 for 2 rounds
   (each unmasked aggregate within 8 · 2^-16 of the float64 mean of the
   pre-mask payloads, K3 = 16 and nothing else), a servicer restarted on
   the persisted directory (round and global model bit-equal), a round
   with one client stopped after the share phase (completed on the 7
   survivors' mean), a distributed-DP round (no kernel, ε charged at the
   threshold and by the coordinator equal, the decoded noise std within
   5% of the plan's σ) and the two command lines' services for one round
   with /health, /status and /metrics/prometheus read over HTTP and the
   shutdown order checked; rounds/s, a client's roster / share / mask /
   reveal ms against its train stage, the unmask ms, peak memory; then
   Oort client selection (``phase_selection``): ``OortSelector(512,
   seed=0)`` picking 64 clients a round for the ``"residual"`` bench
   round, one warm-up and 4 selected rounds one after another (each mask
   64 ones and 64 participants, K1/K2 10 and K3 2 a round, finite losses
   at the picks, the selector's state equal to a host selector's fed the
   same losses; rounds/s and peak memory); then the entry points and
   the experiment drivers (``phase_entry_experiments``): ``entry()``'s
   forward against the CPU's within 1e-5, ``dryrun_multichip(2)`` on two
   gloo ranks sharing the card with K3 on each, and every driver of
   ``fl_tpu_torch.experiments`` once at a cut size, timed, its closing
   line and record checked;
6. learning check: 10 non-IID clients, 3 rounds, test accuracy > 0.5, with
   ``fused_conv_block="residual"`` and with ``True``, and with
   ``"residual"`` under SCAFFOLD (SGD lr 0.05), under FedNova (SGD lr
   0.05, momentum 0.9, epoch budgets 1 + (i mod 3) of 3), under FedDyn
   (α = 0.01, Adam) and under q-FFL at q = 0.05 (SGD lr 0.1), with q = 1
   and q = 0 printed beside it and each one's per-client accuracy spread;
   and at a weak budget under dp_sgd (the microbatch fold on K1/K2, z =
   0.005), dp_ftrl (z = 1e-3, every client in each cohort, momentum 0)
   and distributed DP (z = 1e-3);
7. the conv-formulations measurement at the bench shapes (512 clients x 32
   images, bf16): conv2 14x14 32->64 as library convolution, shift-GEMM
   (``conv3x3_same``) and patch GEMM (``conv3x3_patch``), forward and
   forward + backward; the stem 28x28 1->32 + relu + pool as library chain
   and as ``conv_stem_s2d``, forward and forward + (w, b) gradients; the
   probes ``batched_gemm`` against ``torch.bmm`` and ``taploop_conv``
   against the library convolution. Each formulation is first held to the
   library result, then timed; the launch counts of K7 and K8 are checked
   (the stem launches no input gradient);
8. the kernel table as one JSON line, the card line, and the final
   ``{"ok": true, ...}`` line.

In the kernel table ``bound_ms`` is the larger of the bytes the function
must move over 3.35 TB/s and its floating-point operations over the peak
for its input type (989 TFLOP/s for bf16, the tensor cores), counting for
the sparse products what this run's data needs: the conv2 weight and input
gradients over the non-zeros of dz2 (one routed member per pooled position).
The backward kernels run those two products densely over the 14x14 plane,
so their bound reads "bytes" although they are bound by operations as
written; the dense count is printed beside it on the ``times`` line.
``library_ms`` is, for the conv kernels, the unfused cuDNN formulation of
the same segment (forward, or backward through autograd) on the same
inputs, itself held to the plain version here: no single library call
computes the fused function; it is null where there is no counterpart.
``conv_stack_packed`` has no kernel of its own: its ``launches`` are those
of ``conv_stack_fwd`` plus ``conv_stack_bwd`` during its own call. For K7
and K8 one library call does compute the same function: ``library_ms`` is
``F.conv2d`` with one group per client (or the weight-gradient half of its
backward) on the same values already in its own (B, C*I, H, W) layout, and
``torch.bmm``. ``conv3x3_patch_gemm`` is the forward; the input gradient is
the same kernel on the cotangent and its numbers are on the
``kernels (K7)`` line.

Needs one CUDA device; imports nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

# bench.py's workload
NUM_CLIENTS = 512
SAMPLES_PER_CLIENT = 64
LOCAL_EPOCHS = 5
BATCH_SIZE = 32
EPS_R = 1.0 / 28   # bench.py: epsilon / (rounds + 8) at its 20 rounds
DELTA_R = 1e-5 / 28
N_PARAMS = 421642  # SimpleCNN
SIMPLE_CNN_LEAVES = 8

# published peaks of one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12    # on the CUDA cores

# relative Frobenius tolerances of the unfused bf16 chain's gradients: see
# check_unfused
UNFUSED_GRAD_TOL = 1e-2
FORMULATION_GRAD_TOL = 0.2

# the compressed bench rounds (phase_compression)
TOPK_RATIO = 0.01
POWERSGD_RANK = 4
COMPRESSED_ENGINES = (
    {"uplink_compression": "int8"},
    {"uplink_compression": "topk", "uplink_topk_ratio": TOPK_RATIO},
    {"uplink_compression": "powersgd", "uplink_powersgd_rank": POWERSGD_RANK},
    {"downlink_compression": "bfloat16"},
    {"downlink_compression": "int8"},
    {"downlink_compression": "int8", "uplink_compression": "topk",
     "uplink_topk_ratio": TOPK_RATIO},
)
COMPRESSED_ROUNDS = 2
COMPRESSION_ROWS = slice(0, NUM_CLIENTS, NUM_CLIENTS // 8)  # 8 clients

# the central-DP rounds (phase_central_dp): McMahan et al. 2018's DP-FedAvg
# at client level on the bench workload
CDP_RATE = 0.1          # q: Poisson participation, m̄ = q·N = 51.2
CDP_Z = 1.0             # noise multiplier
CDP_CLIP = 1.0          # C
CDP_EPSILON = 8.0
CDP_DELTA = 1e-5
CDP_ROUNDS = 3
AUDIT_CANARIES = 16
AUDIT_ROUNDS = 10
# clip_client_deltas + the fixed-m̄ mean against f64 on the host, relative
# Frobenius norm per leaf (f32 sums of 51 clients' rows)
CDP_MEAN_TOL = 1e-6

# the slice's local-training and server-side rounds (phase_fl_variants):
# V1 SGD + FedNova on heterogeneous budgets, V2 AdamW + FedProx + bf16
# parameter storage + median, V3 SCAFFOLD, V4 FedAdam + secure aggregation
VARIANTS = ("V1", "V2", "V3", "V4")
VARIANT_ROUNDS = 2
# V1's per-round ε: at the bench's ε_r = 1/28 the global model carries
# σ/√512 ≈ 6.8 of noise an element after one round, and SGD's steps, which
# scale with the gradient (Adam's do not), overflow to inf within the next
# round's 10 steps; at ε_r = 8 (σ ≈ 0.61 a client) SGD stays finite
V1_EPS_R = 8.0
V1_DELTA_R = 1e-5 / 8
TRIM_K = 25
KRUM_F = 1
KRUM_M = (1, 8)
AGG_COLUMNS = 4096       # columns sampled for the f64 reference
AGG_DROP = 0.1           # share of clients out of the aggregator checks
ROUNDING_SEEDS = 64
# f32 against the host's f64 on the sampled columns, relative to the
# largest |value| (a trimmed mean sums ~460 f32 values)
AGG_TOL = 1e-5
# Krum: the selection must be one that f64 scores allow, up to this share
# of a score (the Gram product's f32 rounding)
KRUM_SCORE_TOL = 1e-5

# the server side's second half and the engine's other entry points
# (phase_engine_api): V5 FedDyn at α = 0.01 (Acar et al. 2021 sweep α in
# {0.1, 0.01, 0.001}), V6 q-FFL at q = 1, V7 PEFT (the conv layers train)
# under the bench's delta DP, V8 the bench round through run_rounds_fused
API_CELLS = ("V5", "V6", "V7")
API_ROUNDS = 2
FEDDYN_ALPHA = 0.01
QFFL_Q = 1.0
# the learning check's q: at q = 1 a round's step is far shorter than
# FedAvg's on 10 non-IID clients (qffl_learning_check)
QFFL_LEARN_Q = 0.05
PEFT_PATTERNS = (r".*conv.*",)
FUSED_ROUNDS = 3
# V5's pipelined rounds leave every 8th client out, whose g_i must keep
# their bits
FEDDYN_OUT = slice(0, NUM_CLIENTS, 8)

# the fused conv kernels' second geometry (H, C1, C2): widths that are no
# multiples of 16, so the tensor-core route pads its channels
G2_GEOMETRY = (16, 12, 20)
# conv2 of SimpleCNN and the stem after space-to-depth, (H, W, I, O)
CONV2_SHAPE = (14, 14, 32, 64)
S2D_STEM_SHAPE = (14, 14, 4, 128)
# the probe's bare GEMM: conv2's patch matrix with the padded 16x16 grid's
# rows, (M, K, N) per client
# the other DP mechanisms on the bench round (phase_dp_mechanisms)
MECH_DELTA = 1e-5
MECH_ROUNDS = 2         # pipelined, after a warm-up round
DPSGD_Z = 2.0           # σ = z·C/B a step
DPSGD_CLIP = 1.0
DPSGD_EPSILON = 16.0    # ε after 3 rounds (30 steps at q = 0.5): 8.56
DPSGD_MICRO = 16        # dp_microbatch: 2 chunks a step, (8192, 1) folds
DPSGD_PLD_DT = 1e-3
FTRL_Z = 1.0            # ε = 4.38 for the whole tree (analytic Gaussian)
FTRL_EPSILON = 8.0
FTRL_T = 8              # tree height 4; rotation allows 10 rounds at k = 1
DIST_Z = 1.0
DIST_CLIP = 1.0
DIST_EPSILON = 64.0
# the CIFAR-10 slice (phase_cifar): the bench's round shape with
# CIFAR10CNN(norm="batch") and augmentation, and DP-SGD ghost on
# CIFAR10CNN(norm="group") at scripts/dp_sgd_cifar_eps15.py's shape
CIFAR_ROUNDS = 2        # pipelined, after a warm-up round
CIFAR_PARAMS = 1_470_890
CIFAR_STATS = 896
# K3's groups at CIFAR10CNN, in launch order: the standalone leaves of at
# least 65,536 elements a client (conv5, conv6, fc1, fc2 kernels), then
# the concatenated rest (batch_stats and the small params)
CIFAR_K3_GROUPS = (73_728, 147_456, 1_048_576, 131_072, 70_954)
GHOST_CLIENTS = 24
GHOST_SAMPLES = 4096
GHOST_BATCH = 256
GHOST_LR = 0.05
GHOST_EPSILON = 1.5     # the script's target over its 30 rounds
GHOST_PLANNED_ROUNDS = 30
GHOST_ROUNDS = 2        # run here, after a warm-up round
GHOST_DELTA = 1e-5
# the rest of the model zoo (phase_zoo), each path at the bench's
# training options: FederatedResNet (the cifar100 route, 100 classes,
# published widths) with the CIFAR augmentation, FederatedViT with rank-4
# LoRA adapters under lora_trainable_patterns(), LightweightMobileNet at
# the factory's width 0.5
ZOO_RESNET_CLIENTS = 128   # the one cut from the bench's 512 (PERF.md §4)
ZOO_ROUNDS = 2             # pipelined, after a warm-up round
RESNET_PARAMS = 2_800_804
RESNET_STATS = 4_480
# K3's groups at the ResNet, in launch order: the layer2 / layer3 conv
# kernels of at least 65,536 elements a client, then the rest with the
# batch statistics; one group for the ViT and the MobileNet (no leaf
# reaches 65,536)
RESNET_K3_GROUPS = (73_728, 147_456, 147_456, 147_456, 294_912, 589_824,
                    589_824, 589_824, 224_804)
VIT_LORA_PARAMS = 574_602
MOBILENET_PARAMS = 73_130
MOBILENET_STATS = 2_240
ZOO_BENCH_ITERS = 20
MERGE_F32_TOL = 1e-4    # merged vs unmerged logits, of the largest logit
MERGE_BF16_TOL = 3e-2   # relative Frobenius, bf16 forwards
PROBE_GEMM_SHAPE = (BATCH_SIZE * 16 * 16, 9 * 32, 64)
# K8a's small cases: whole tiles, edges ragged in every dimension (no
# 16-byte rows: the staged route); in bf16 also one client of the bench
# shape and N over 64 (three column passes)
PROBE_GEMM_SMALL = {
    "float32": ((2, 128, 288, 64), (3, 70, 50, 37)),
    "bfloat16": ((2, 128, 288, 64), (3, 70, 50, 37), (2, 8192, 288, 64),
             (1, 300, 64, 136)),
}
# K8b's small cases, (B, (H, W, I, O)) with 3 clients, and the route each
# takes in bf16 (f32 always takes the CUDA cores): a tile over two images,
# channels TMA cannot address (I = 4, 3), a ragged last tile of 105 rows
TAPLOOP_SMALL = {(2, CONV2_SHAPE): "tma", (1, (28, 28, 4, 8)): "cuda_core",
                 (3, (5, 7, 3, 6)): "cuda_core", (3, (5, 7, 16, 8)): "tma"}
# two formulations of one bf16 convolution round the same f32 sum, so they
# differ by rare one-ulp flips; a library algorithm that transforms the
# operands adds its own rounding. Relative Frobenius norm.
FORMULATION_TOL = 1e-2
# the kernels the conv-formulations path launches
FORMULATION_KERNELS = ("conv3x3_patch_gemm", "conv3x3_patch_wgrad",
                       "probe_batched_gemm", "probe_taploop_conv")


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


def bound(n_bytes, flops, peak=BF16_FLOPS):
    """(bound_ms, bound_by) of a function that must move n_bytes and do
    flops operations whose inputs' type runs at peak (bf16 by default)."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def nbytes_gemm(C, M, K, N, size=2):
    """Bytes a batched GEMM must move: a and b read once, the output
    written once."""
    return size * C * (M * K + K * N + M * N)


def bf16_ulp(t):
    """One bf16 ulp at each element's magnitude (8 significant bits)."""
    import torch

    mag = t.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def ulp_gap(a, b):
    """(largest |a - b| beyond 1e-4 in bf16 ulps of the larger magnitude,
    the measure check_rounded holds to 1; share of elements that are
    bit-equal) of two bf16 tensors."""
    import torch

    a, b = a.float(), b.float()
    ulps = ((a - b).abs() - 1e-4).clamp(min=0) / bf16_ulp(
        torch.maximum(a.abs(), b.abs()))
    return float(ulps.max()), float((a == b).float().mean())


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
    # the entry casts of the fused ops: weights to the compute dtype,
    # biases rounded to it and then added in f32
    return (x.to(dtype), w1.to(dtype), b1.to(dtype).float(), w2.to(dtype),
            b2.to(dtype).float())


def check_pooled(name, tag, pooled, p_ref, dtype, ulps=1, at_least=0.0):
    """bf16: within `ulps` bf16 ulps of the larger of the two values, or of
    `at_least` where both are smaller; f32: 1e-5."""
    import torch

    pk, pr = pooled.float(), p_ref.float()
    err = float((pk - pr).abs().max())
    if dtype == torch.float32:
        require(torch.allclose(pk, pr, rtol=1e-5, atol=1e-5),
                f"{name} {tag}: pooled off by {err} (tol 1e-5)")
    else:
        # one ulp at the larger of the two values; the 1e-5 floor covers
        # sums that straddle zero before relu, where the two f32
        # accumulation orders may round to 0 on one side only
        tol = ulps * bf16_ulp(torch.maximum(pk.abs(), pr.abs()).clamp(
            min=at_least)) + 1e-5
        over = (pk - pr).abs() > tol
        require(not bool(over.any()),
                f"{name} {tag}: {int(over.sum())} pooled values off by more "
                f"than {ulps} bf16 ulp, e.g. {pk[over][:4].tolist()} vs "
                f"{pr[over][:4].tolist()}")
    return err


def check_grads(name, tag, got, want, dtype):
    import torch

    worst = 0.0
    for leaf, a, b in zip(("dw1", "db1", "dw2", "db2"), got, want):
        worst = max(worst, float((a - b).abs().max()))
        if dtype == torch.float32:
            require(torch.allclose(a, b, rtol=2e-4, atol=2e-4),
                    f"{name} {tag} {leaf}: off by "
                    f"{float((a - b).abs().max())} (tol 2e-4)")
        else:
            rel = float((a - b).norm() / b.norm().clamp(min=1e-30))
            require(rel <= 1e-2, f"{name} {tag} {leaf}: relative Frobenius "
                                 f"error {rel} (tol 1e-2)")
    return worst


def check_index(name, tag, cb, args, idx, i_ref, p_ref):
    """K1's pool2 window index may differ from the plain version's only
    where the plain window holds a near-tie: the kernel's chosen member
    within one ulp of the window max. Returns where they differ."""
    import torch

    pr = p_ref.float()
    bad = idx != i_ref
    if bool(bad.any()):
        win = cb.pool2_windows_plain(*args)
        chosen = win.gather(-1, idx.long()[..., None])[..., 0]
        near = (chosen - pr).abs() <= (
            bf16_ulp(pr) + 1e-5 if args[0].dtype != torch.float32
            else 1e-5 * (1 + pr.abs()))
        require(bool(near[bad].all()),
                f"{name} {tag}: {int(bad.sum())} window indices differ "
                "beyond near-ties")
    return bad


def check_conv(cb, gen, C, B, dtype, constant=False, geo=(28, 32, 64)):
    """K1, K2 and K4 against their plain versions, and K4 against K1/K2,
    on the same inputs; `geo` is (H, C1, C2). Returns the errors and the
    tensors for timing."""
    import torch

    H, C1, C2 = geo
    args = conv_inputs(gen, C, B, dtype, H=H, C1=C1, C2=C2, constant=constant)
    x, w1, b1, w2, b2 = args
    tag = (f"{str(dtype)[6:]} C={C} B={B} H={H} C1={C1} C2={C2}"
           f"{' all-ties' if constant else ''}")
    pooled, idx = cb.conv_block_fwd_cuda(*args)
    pooled4 = cb.conv_stack_fwd_cuda(*args)
    p_ref, i_ref = cb.conv_stack_res_fwd_plain(*args)
    pooled_again, idx_again = cb.conv_block_fwd_cuda(*args)
    torch.cuda.synchronize()
    err = {"conv_block_fwd": check_pooled("K1", tag, pooled, p_ref, dtype),
           "conv_stack_fwd": check_pooled(
               "K4 fwd", tag, pooled4, cb.conv_stack_fwd_plain(*args), dtype)}
    # one template: K4's forward is K1 without the index, bit for bit
    require(torch.equal(pooled, pooled4), f"K4 fwd {tag}: not bit-equal to K1")
    require(torch.equal(pooled, pooled_again) and torch.equal(idx, idx_again),
            f"K1 {tag}: two runs differ")
    bad = check_index("K1", tag, cb, args, idx, i_ref, p_ref)
    # K2 on identical routing: the plain version's idx for both
    g_raw = torch.randn(pooled.shape, generator=gen, device="cuda").to(dtype)
    g = (g_raw * (p_ref > 0)).to(dtype).contiguous()
    got = cb.conv_block_bwd_cuda(g, i_ref, x, w1, b1, w2)
    want = cb.conv_stack_res_bwd_plain(g, i_ref, x, w1, b1, w2)
    again2 = cb.conv_block_bwd_cuda(g, i_ref, x, w1, b1, w2)
    torch.cuda.synchronize()
    err["conv_block_bwd"] = check_grads("K2", tag, got, want, dtype)
    require(all(torch.equal(a, b) for a, b in zip(got, again2)),
            f"K2 {tag}: two runs differ")
    # K4's backward finds its own routing and relu2'. Where they are the
    # plain version's, it is held to conv_stack_bwd_plain; where a near-tie
    # (checked above) sent the kernel elsewhere, to the plain backward on
    # the kernel's routing.
    same_route = not bool(bad.any()) and torch.equal(pooled > 0, p_ref > 0)
    got4 = cb.conv_stack_bwd_cuda(g_raw, *args)
    g_k = (g_raw * (pooled > 0)).to(dtype).contiguous()
    want4 = (cb.conv_stack_bwd_plain(g_raw, *args) if same_route else
             cb.conv_stack_res_bwd_plain(g_k, idx, x, w1, b1, w2))
    # K4 against K2 fed K1's own residuals: the same function
    got2 = cb.conv_block_bwd_cuda(g_k, idx, x, w1, b1, w2)
    again = cb.conv_stack_bwd_cuda(g_raw, *args)
    torch.cuda.synchronize()
    err["conv_stack_bwd"] = check_grads("K4 bwd", tag, got4, want4, dtype)
    # both dtypes: K4's recompute finds K1's index and mask, and from there
    # K4 and K2 run one body
    require(all(torch.equal(a, b) for a, b in zip(got4, got2)),
            f"K4 bwd {tag}: not bit-equal to K2 fed K1's residuals")
    require(all(torch.equal(a, b) for a, b in zip(got4, again)),
            f"K4 bwd {tag}: two runs differ")
    return dict(err=err, args=args, g=g, idx=i_ref, g_raw=g_raw,
                same_route=same_route)


def unfused_reference(x, w1, b1, w2, b2):
    """The unfused chain in f32 with the compute dtype's roundings placed by
    hand where flax places them (each conv's output, then the bias sum),
    differentiable through the roundings as the identity. Same shapes as
    ``conv_segment_unfused``; the oracle for its bf16 run on the card."""
    import torch
    import torch.nn.functional as F

    cdt = x.dtype
    C, B, H, W, _ = x.shape

    def rnd(t):
        return t + (t.to(cdt).float() - t).detach()

    h = x.float().reshape(C, B, H, W).permute(1, 0, 2, 3)
    for w, b in ((w1, b1), (w2, b2)):
        wg = w.float().permute(0, 4, 3, 1, 2).reshape(-1, w.shape[3], 3, 3)
        h = rnd(F.conv2d(h, wg, padding=1, groups=C))
        h = F.max_pool2d(torch.relu(rnd(h + b.float().reshape(1, -1, 1, 1))),
                         2)
    return h.reshape(B, C, w2.shape[-1], H // 4, W // 4).permute(
        1, 0, 3, 4, 2)


def _rel(a, b):
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp(min=1e-30))


def check_unfused(cb, segment, case):
    """Hold the unfused chain (library convolutions through autograd) to
    plain PyTorch on one case's inputs, values and gradients.

    f32: the plain version of the fused segment is the same arithmetic
    (pooled 1e-5, gradients 2e-4, relative and absolute).

    bf16, against :func:`unfused_reference` (the same cast points in f32):
    pooled within 2 bf16 ulps of the larger value, or of 1.0 where both are
    smaller (two roundings a layer; and a pool1 value that lands an ulp
    apart moves conv2's sum by w2 times that ulp, whatever the size of the
    sum itself), gradients UNFUSED_GRAD_TOL in relative Frobenius norm
    (autograd rounds every intermediate gradient to bf16, the reference
    none).

    bf16, against the plain fused segment: the chain rounds each conv's
    output before the bias is added and again after, the fused segment
    once, so values differ by an ulp in places and a pool window that is a
    near-tie sends its gradient to another member. Pooled 1e-2 in relative
    Frobenius norm; the gradients' distance is reported and held under
    FORMULATION_GRAD_TOL (a wrong gradient is at 1 or more)."""
    import torch

    args, g_raw = case["args"], case["g_raw"]
    x = args[0]
    tag = f"unfused {str(x.dtype)[6:]} C={x.shape[0]}"

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in args[1:]]
        out = fn(x, *leaves)
        return out.detach(), torch.autograd.grad(out, leaves, g_raw.to(
            out.dtype))

    out, grads = run(segment)
    # the oracles in true f32, whatever the switch says during this call
    tf32, torch.backends.cudnn.allow_tf32 = (
        torch.backends.cudnn.allow_tf32, False)
    try:
        p_fused = cb.conv_stack_fwd_plain(*args)
        g_fused = cb.conv_stack_bwd_plain(g_raw, *args)
        if x.dtype != torch.float32:
            p_ref, g_ref = run(unfused_reference)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.synchronize()
    if x.dtype == torch.float32:
        require(torch.allclose(out, p_fused, rtol=1e-5, atol=1e-5),
                f"{tag}: pooled off by "
                f"{float((out - p_fused).abs().max())} (tol 1e-5)")
        for a, b in zip(grads, g_fused):
            require(torch.allclose(a, b, rtol=2e-4, atol=2e-4),
                    f"{tag}: a gradient off by {float((a - b).abs().max())} "
                    "(tol 2e-4)")
        return None
    check_pooled(tag, "vs its f32 reference", out, p_ref, x.dtype, ulps=2,
                 at_least=1.0)
    m = dict(ref_grad=max(_rel(a, b) for a, b in zip(grads, g_ref)),
             fused_pooled=_rel(out, p_fused),
             fused_grad=max(_rel(a, b) for a, b in zip(grads, g_fused)))
    require(m["ref_grad"] <= UNFUSED_GRAD_TOL,
            f"{tag}: gradients {m['ref_grad']} from the f32 reference in "
            f"relative Frobenius norm (tol {UNFUSED_GRAD_TOL})")
    require(m["fused_pooled"] <= 1e-2
            and m["fused_grad"] <= FORMULATION_GRAD_TOL,
            f"{tag}: against the fused segment pooled {m['fused_pooled']} "
            f"(tol 1e-2), gradients {m['fused_grad']} (tol "
            f"{FORMULATION_GRAD_TOL})")
    return m


def conv_work(args, g_masked):
    """Bytes and bf16-input operations of the conv kernels at these inputs:
    per image conv1 (H*W*9*C1 FMA) and conv2 (H1*W1*9*C1*C2) forward; in
    the backward the stem again, the conv2 weight and input gradients over
    the non-zeros of dz2 (one routed member per pooled position, fewer
    after relu2'), and the stem weight gradient."""
    x, w1, b1, w2, b2 = args
    C, B, H, W, _ = x.shape
    C1, C2 = w1.shape[-1], w2.shape[-1]
    n_img = C * B
    stem = H * W * 9 * C1
    conv2 = (H // 2) * (W // 2) * 9 * C1 * C2
    nnz = int((g_masked != 0).sum())
    stem_wgrad = (H // 2) * (W // 2) * C1 * 9
    fwd_flops = 2 * n_img * (stem + conv2)
    bwd_flops = 2 * (n_img * (stem + stem_wgrad) + 2 * nnz * 9 * C1)
    pooled = n_img * (H // 4) * (W // 4) * C2 * x.element_size()
    grads = 4 * C * (9 * C1 + C1 + 9 * C1 * C2 + C2)
    io = {
        "conv_block_fwd": nbytes(*args) + pooled + pooled // x.element_size(),
        "conv_block_bwd": nbytes(x, w1, b1, w2) + pooled
        + pooled // x.element_size() + grads,
        "conv_stack_fwd": nbytes(*args) + pooled,
        "conv_stack_bwd": nbytes(*args) + pooled + grads,
    }
    flops = {"conv_block_fwd": fwd_flops, "conv_block_bwd": bwd_flops,
             "conv_stack_fwd": fwd_flops,
             "conv_stack_bwd": bwd_flops + 2 * n_img * conv2}
    # the two conv2 gradient products as the kernels run them: dense
    dense = 2 * n_img * (stem + stem_wgrad + 2 * conv2)
    dense_ms = {"conv_block_bwd": bound(io["conv_block_bwd"], dense)[0],
                "conv_stack_bwd": bound(io["conv_stack_bwd"],
                                        dense + 2 * n_img * conv2)[0]}
    return {k: bound(io[k], flops[k]) for k in io}, dense_ms


def phase_conv(report):
    import torch

    from fl_tpu_torch.models.simple_cnn import conv_segment_unfused
    from fl_tpu_torch.ops import conv_block as cb

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    # small cases in both dtypes: random and all-tie images at the bench
    # widths, and a second geometry with widths that are no multiples of 16
    # (the tensor-core route's padded channels) and a batch that is no
    # multiple of IMAGES_PER_BLOCK
    routes = {}
    for dtype in (torch.float32, torch.bfloat16):
        before = dict(cb.ROUTE_LAUNCHES)
        cases.append(check_conv(cb, gen, 4, BATCH_SIZE, dtype))
        cases.append(check_conv(cb, gen, 2, BATCH_SIZE, dtype, constant=True))
        cases.append(check_conv(cb, gen, 3, 5, dtype, geo=G2_GEOMETRY))
        took = {k: v - before[k] for k, v in cb.ROUTE_LAUNCHES.items()
                if v != before[k]}
        require({r for _, r in took} == {cb.ROUTES[dtype]}
                and {k for k, _ in took} == set(cb.LAUNCHES),
                f"K1/K2/K4 {dtype}: launches by (kernel, route) {took}")
        routes[str(dtype)[6:]] = cb.ROUTES[dtype]
        # the launch plans' shared-memory counts are the library's own
        for geo in ((28, 28, 32, 64), (16, 16, 12, 20), (16, 16, 8, 16)):
            for kernel in cb.LAUNCHES:
                plan = cb.launch_plan(kernel, dtype, *geo)
                got = cb.kernel_smem_bytes(kernel, dtype, *geo)
                require(plan.smem_bytes == got, f"{kernel} {dtype} {geo}: "
                        f"plan {plan} against {got} B in the library")
    plans = {k: cb.launch_plan(k, torch.bfloat16, 28, 28, 32, 64)
             for k in cb.LAUNCHES}
    print(f"routes (K1/K2/K4): {routes} (every launch of the small cases "
          f"took its dtype's route; bf16's conv2 and its gradients on "
          f"mma.sync, f32 on the CUDA cores; plans at the bench widths in "
          f"bf16: " + "; ".join(
              f"{k} {p.instruction} {p.threads} threads {p.smem_bytes} B"
              for k, p in plans.items()) + ")", flush=True)
    # the bench shapes of the main path (bf16), with the times
    big = check_conv(cb, gen, NUM_CLIENTS, BATCH_SIZE, torch.bfloat16)
    cases.append(big)
    args, g, idx, g_raw = big["args"], big["g"], big["idx"], big["g_raw"]
    x, w1, b1, w2, b2 = args
    bounds, dense_ms = conv_work(args, g)

    # the library yardstick: the unfused cuDNN chain, held to the plain
    # version and then timed on the same inputs
    unfused_err = [check_unfused(cb, conv_segment_unfused, c)
                   for c in cases]
    # f32 stays f32 when the caller has left cuDNN's TF32 switch on
    torch.backends.cudnn.allow_tf32 = True
    try:
        check_unfused(cb, conv_segment_unfused, cases[0])
    finally:
        torch.backends.cudnn.allow_tf32 = False
    leaves = [t.clone().requires_grad_(True) for t in (w1, b1, w2, b2)]
    with torch.no_grad():
        lib_fwd = time_ms(lambda: conv_segment_unfused(x, *leaves))
    out = conv_segment_unfused(x, *leaves)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, leaves, g_raw, retain_graph=True))
    del out

    timed = {
        "conv_block_fwd": (
            lambda: cb.conv_block_fwd_cuda(*args),
            lambda: cb.conv_stack_res_fwd_plain(*args), lib_fwd),
        "conv_block_bwd": (
            lambda: cb.conv_block_bwd_cuda(g, idx, x, w1, b1, w2),
            lambda: cb.conv_stack_res_bwd_plain(g, idx, x, w1, b1, w2),
            lib_bwd),
        "conv_stack_fwd": (
            lambda: cb.conv_stack_fwd_cuda(*args),
            lambda: cb.conv_stack_fwd_plain(*args), lib_fwd),
        "conv_stack_bwd": (
            lambda: cb.conv_stack_bwd_cuda(g_raw, *args),
            lambda: cb.conv_stack_bwd_plain(g_raw, *args), lib_bwd),
    }
    for name, (kernel, plain, lib_ms) in timed.items():
        report[name]["instruction"] = plans[name].instruction
        report[name].update(
            max_abs_err=big["err"][name], ms=time_ms(kernel),
            plain_ms=time_ms(plain), bound_ms=bounds[name][0],
            bound_by=bounds[name][1], library_ms=lib_ms)

    # K5: conv_stack_packed == conv_stack per client, bit for bit
    worst = 0.0
    for P in (1, 2, 4, 3):
        xs, *ws = conv_inputs(gen, P, BATCH_SIZE, torch.bfloat16)
        r = torch.randn((P, BATCH_SIZE, 7, 7, 64), generator=gen,
                        device="cuda").bfloat16()
        wp = [t.clone().requires_grad_(True) for t in ws]
        out_p = cb.conv_stack_packed(xs, *wp)
        grads_p = torch.autograd.grad(out_p, wp, r)
        for c in range(P):
            wc = [t[c:c + 1].clone().requires_grad_(True) for t in ws]
            out_c = cb.conv_stack(xs[c:c + 1], *wc)
            grads_c = torch.autograd.grad(out_c, wc, r[c:c + 1])
            torch.cuda.synchronize()
            require(torch.equal(out_p[c:c + 1], out_c),
                    f"K5 P={P}: client {c}'s output differs from conv_stack")
            for a, b in zip(grads_p, grads_c):
                worst = max(worst, float((a[c:c + 1] - b).abs().max()))
                require(torch.equal(a[c:c + 1], b),
                        f"K5 P={P}: client {c}'s gradients differ from "
                        "conv_stack")
    # K5 at the bench shapes: forward + backward through the entry point
    wp = [t.clone().requires_grad_(True) for t in (w1, b1, w2, b2)]

    def packed_step():
        return torch.autograd.grad(cb.conv_stack_packed(x, *wp), wp, g_raw)

    def plain_step():
        cb.conv_stack_fwd_plain(*args)
        return cb.conv_stack_bwd_plain(g_raw, *args)

    b_ms = bounds["conv_stack_fwd"][0] + bounds["conv_stack_bwd"][0]
    report["conv_stack_packed"].update(
        max_abs_err=worst, ms=time_ms(packed_step),
        plain_ms=time_ms(plain_step), bound_ms=b_ms,
        bound_by=bounds["conv_stack_bwd"][1], library_ms=lib_fwd + lib_bwd)

    report["conv_block_bwd"]["dense_ms"] = dense_ms["conv_block_bwd"]
    report["conv_stack_bwd"]["dense_ms"] = dense_ms["conv_stack_bwd"]
    bf = [m for m in unfused_err if m is not None]
    n_route = sum(c["same_route"] for c in cases)
    print(f"kernels (conv): K1/K2/K4 f32+bf16 (random, all-ties, and "
          f"H={G2_GEOMETRY[0]} C1={G2_GEOMETRY[1]} C2={G2_GEOMETRY[2]} B=5) "
          f"and bench shapes match plain; in all {len(cases)} cases K4 fwd "
          f"== K1 and K4 bwd == K2 fed K1's residuals bit for bit, and K1, K2 "
          f"and K4 bwd each repeat bit for bit; routing equal to plain's in "
          f"{n_route}/{len(cases)} (the others differ only at near-ties); "
          f"K5 == conv_stack bit for bit for P in (1, 2, 4, 3); unfused "
          f"cuDNN segment matches plain in all {len(cases)}, f32 also "
          f"with cudnn.allow_tf32 on (f32 1e-5 / 2e-4; bf16 against its f32 "
          f"reference 2 ulps, gradients "
          f"{max(m['ref_grad'] for m in bf):.2e} relative Frobenius; "
          f"against the fused segment pooled "
          f"{max(m['fused_pooled'] for m in bf):.2e}, gradients "
          f"{max(m['fused_grad'] for m in bf):.2e}), fwd {lib_fwd:.3f} ms, "
          f"bwd {lib_bwd:.3f} ms", flush=True)


def philox_oracle():
    """The numpy Philox4x32-10 of the tests (tests/philox_oracle.py)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "philox_oracle", os.path.join(ROOT, "tests", "philox_oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corr(a, b):
    import torch

    return float(torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1])


def phase_dp(report):
    import numpy as np
    import torch

    from fl_tpu_torch.core import prng
    from fl_tpu_torch.fl.privacy import STANDALONE_MIN
    from fl_tpu_torch.ops import dp as dpo

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    # K3 at the two DP groups of SimpleCNN at the bench: fc1's kernel and
    # the concatenated small leaves
    C = NUM_CLIENTS
    widths = (7 * 7 * 64 * 128, N_PARAMS - 7 * 7 * 64 * 128)
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
    # x read once, the output written once, three (C,) vectors. The
    # operations: about 10 f32 ones an element (Box–Muller for a pair
    # shared by two elements, then x * scale + sigma * z) over the 67
    # TFLOP/s f32 peak, far under the bytes. Philox's integer work has no
    # line in the card's table of peaks; it held the old design, which
    # drew a whole Philox call an element, at 2.2x this bound.
    n = sum(xg.numel() for xg, _, _ in groups)
    b_ms, b_by = bound(8 * n + 2 * 16 * C, 10 * n, F32_FLOPS)
    report["clip_noise"].update(
        max_abs_err=err,
        ms=time_ms(lambda: [dpo.clip_noise_cuda(xg, s, sig, sd)
                            for xg, s, sd in groups]),
        plain_ms=time_ms(lambda: [dpo.clip_noise_plain(xg, s, sig, sd)
                                  for xg, s, sd in groups], reps=2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del groups

    # the stream itself: x = 0, scale = 0, sigma = 1 gives z, which must be
    # the numpy Philox4x32-10 oracle's words through K3's counter map and
    # Box–Muller, to 1e-5 (the card's log, sqrt, sin and cos), at ragged
    # widths and with the seeds of two real clients
    oracle = philox_oracle()
    seeds = prng.as_int64(prng.client_stream_seeds(rseed, 2,
                                                   prng.Stream.DP_NOISE, 1))
    worst = 0.0
    for D in (1, 3, 4097, widths[1]):
        z = dpo.clip_noise_cuda(torch.zeros((2, D), device="cuda"),
                                torch.zeros(2, device="cuda"),
                                torch.ones(2, device="cuda"),
                                torch.as_tensor(seeds).cuda()).cpu().numpy()
        counter, word = (t.numpy() for t in dpo.noise_layout(D))
        for c in range(2):
            worst = max(worst, float(np.abs(
                z[c] - oracle.box_muller(seeds[c], counter, word)).max()))
    require(worst <= 1e-5, f"K3 differs from the Philox oracle by {worst} "
            "(tol 1e-5)")

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
    # the elements one Philox call feeds: the cosine and sine of a pair
    # share their radius, so z and z^2 would show a fault there; the two
    # pairs of a call come from other words (2M pairs each, 5e-3 is 7
    # standard errors)
    w = z[0][:, torch.as_tensor(oracle.word_index(*dpo.noise_layout(D)))
              .cuda()]
    cos_sin = max(abs(corr(torch.cat([w[:, 0], w[:, 2]]) ** p,
                           torch.cat([w[:, 1], w[:, 3]]) ** p))
                  for p in (1, 2))
    pairs = max(abs(corr(torch.cat([w[:, 0], w[:, 1]]) ** p,
                         torch.cat([w[:, 2], w[:, 3]]) ** p))
                for p in (1, 2))
    require(cos_sin <= 5e-3 and pairs <= 5e-3,
            f"K3 correlation within a Philox call: cosine/sine {cos_sin}, "
            f"pair/pair {pairs} (tol 5e-3, z and z^2)")
    ks, ks_crit = oracle.ks_normal(flat)
    require(ks <= ks_crit, f"K3 noise: Kolmogorov–Smirnov distance {ks} "
            f"from N(0, 1) above {ks_crit} (significance 1e-3)")
    print(f"kernels (K3): sigma=0 exact to 1e-6, the Philox oracle to "
          f"{worst:.1e} at D=1, 3, 4097, {widths[1]}; noise mean={mean:.2e} "
          f"var={var:.5f} tail3={tail:.5f} corr_clients={corr_c:.1e} "
          f"corr_groups={corr_g:.1e} corr_cos_sin={cos_sin:.1e} "
          f"corr_pairs={pairs:.1e} KS={ks:.2e} (<= {ks_crit:.2e})",
          flush=True)


def quantize_width():
    """One round's client deltas, each padded to whole 2048-blocks."""
    from fl_tpu_torch.ops.quantize import CHUNK

    return NUM_CLIENTS * (-(-N_PARAMS // CHUNK) * CHUNK)


def phase_quantize(report):
    import numpy as np
    import torch

    from fl_tpu_torch.ops import quantize as qz

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    D = quantize_width()
    x = torch.randn((D,), generator=gen, device="cuda") * 1e-3
    # deterministic mode: the plain version exactly, q and scales
    q, s = qz.quantize_int8_blocks_cuda(x, 5, stochastic=False)
    q_ref, s_ref = qz.quantize_int8_blocks_plain(x, 5, stochastic=False)
    torch.cuda.synchronize()
    require(torch.equal(s, s_ref), "K6: block scales differ from the plain "
            f"version's by up to {float((s - s_ref).abs().max())}")
    diff = (q.int() - q_ref.int()).abs()
    require(int(diff.max()) == 0,
            f"K6 deterministic: {int((diff != 0).sum())} of {D} values "
            "differ from the plain version")
    # x read once, q and the scales written once; about 10 f32 operations
    # a value over the f32 peak
    b_ms, b_by = bound(5 * D + 4 * (D // qz.CHUNK), 10 * D, F32_FLOPS)
    report["quantize_int8_blocks"].update(
        max_abs_err=float(diff.max()),
        ms=time_ms(lambda: qz.quantize_int8_blocks_cuda(x, 5)),
        plain_ms=time_ms(lambda: qz.quantize_int8_blocks_plain(x, 5), reps=2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del x, q, s, q_ref, s_ref, diff

    # the stream itself: on 5 blocks every rounding decision is the numpy
    # Philox4x32-10 oracle's uniform through K6's counter map, exactly
    oracle = philox_oracle()
    x = torch.randn((5 * qz.CHUNK,), generator=gen, device="cuda")
    q, s = qz.quantize_int8_blocks_cuda(x, 11)
    xn, sn = x.cpu().numpy(), s.cpu().numpy()
    scaled = (xn.reshape(5, -1) * (np.float32(1) / sn)[:, None]).reshape(-1)
    lo = np.floor(scaled)
    u = oracle.uniforms(11, *(t.numpy() for t in qz.rounding_layout(5)))
    want = np.clip(lo + (u < scaled - lo), -128, 127).astype(np.int8)
    n_off = int((q.cpu().numpy() != want).sum())
    require(n_off == 0, f"K6: {n_off} of {x.numel()} rounding decisions "
            "differ from the Philox oracle's")

    # stochastic mode on 2^22 values, by its distribution
    n = 1 << 22
    x = torch.randn((n,), generator=gen, device="cuda")
    q1, s1 = qz.quantize_int8_blocks_cuda(x, 11)
    q1b, _ = qz.quantize_int8_blocks_cuda(x, 11)
    q2, _ = qz.quantize_int8_blocks_cuda(x, 12)
    torch.cuda.synchronize()
    scaled = (x.reshape(-1, qz.CHUNK) * (1.0 / s1)[:, None]).reshape(-1)
    lo = torch.floor(scaled)
    qf = q1.float()
    ok = (qf == lo.clamp(-128, 127)) | (qf == (lo + 1).clamp(-128, 127))
    require(bool(ok.all()), f"K6 stochastic: {int((~ok).sum())} values are "
            "neither floor nor ceil of x/scale")
    bias = float((qf.double() - scaled.double()).mean())
    require(abs(bias) <= 1e-3, f"K6 stochastic: mean(q - scaled) = {bias} "
            "(tol 1e-3)")
    frac, up = scaled - lo, qf > lo
    worst = 0.0
    for b in range(10):
        sel = (frac >= b / 10) & (frac < (b + 1) / 10)
        worst = max(worst, abs(float(up[sel].float().mean())
                               - float(frac[sel].mean())))
    require(worst <= 0.01, f"K6 stochastic: P(ceil) off the fractional part "
            f"by {worst} in some decile (tol 0.01)")
    # the four values one Philox call rounds: their decisions less their
    # expectations are uncorrelated (1M per quarter, 5e-3 is 5 standard
    # errors)
    e = (up.double() - frac.double())[torch.as_tensor(oracle.word_index(
        *qz.rounding_layout(n // qz.CHUNK))).cuda()]
    quarters = max(abs(corr(e[a], e[b]))
                   for a in range(4) for b in range(a + 1, 4))
    require(quarters <= 5e-3, f"K6 stochastic: decisions of one Philox "
            f"call's quarters correlate by {quarters} (tol 5e-3)")
    require(torch.equal(q1, q1b), "K6 stochastic: same seed, different bits")
    require(not torch.equal(q1, q2), "K6 stochastic: two seeds, same bits")
    print(f"kernels (K6): deterministic mode equals plain exactly at "
          f"D={D}; the Philox oracle's decisions exactly on 5 blocks; "
          f"stochastic on 2^22: floor/ceil only, mean(q - scaled)="
          f"{bias:.2e}, P(ceil) within {worst:.4f} of the fraction per "
          f"decile, quarters' correlation {quarters:.1e}, seeds differ and "
          f"repeat", flush=True)


def check_rounded(name, tag, got, want, dtype):
    """A product summed in f32 and rounded once, against the same in another
    order. f32: rtol 1e-4, atol 1e-4 (the reference's own, tests/
    test_ops.py). bf16: one bf16 ulp of the larger value plus 1e-4 (two f32
    sums that differ in their last bits round to neighbours at most).
    Returns the largest absolute difference."""
    import torch

    a, b = got.float(), want.float()
    err = float((a - b).abs().max())
    if dtype == torch.float32:
        require(torch.allclose(a, b, rtol=1e-4, atol=1e-4),
                f"{name} {tag}: off by {err} (tol rtol 1e-4, atol 1e-4)")
    else:
        over = (a - b).abs() > bf16_ulp(torch.maximum(a.abs(), b.abs())) + 1e-4
        require(not bool(over.any()),
                f"{name} {tag}: {int(over.sum())} values off by more than one "
                f"bf16 ulp, e.g. {a[over][:4].tolist()} vs "
                f"{b[over][:4].tolist()}")
    return err


def check_wgrad(name, tag, got, want, rows):
    """A weight gradient in f32: sums over `rows` output positions in
    another order than the plain version's. rtol 1e-4, atol 2e-4 up to 784
    rows (the reference's own, at its test shapes) and growing with the
    number of terms beyond."""
    import torch

    atol = 2e-4 * max(1.0, rows / 784)
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=1e-4, atol=atol),
            f"{name} {tag}: off by {err} (tol rtol 1e-4, atol {atol:.1e})")
    return err


def patch_inputs(gen, C, B, shape, dtype):
    """x (C, B, H, W, I), w (C, 3, 3, I, O) and a cotangent g (C, B, H, W,
    O) for a convolution, as the reference's measurement draws them."""
    import torch

    H, W, I, O = shape
    x = torch.randn((C, B, H, W, I), generator=gen, device="cuda")
    w = torch.randn((C, 3, 3, I, O), generator=gen, device="cuda") * 0.1
    g = torch.randn((C, B, H, W, O), generator=gen, device="cuda")
    return x.to(dtype), w.to(dtype), g.to(dtype)


def to_library(t):
    """(C, B, H, W, ch) -> the grouped convolution's (B, C*ch, H, W)."""
    C, B, H, W, ch = t.shape
    return t.permute(1, 0, 4, 2, 3).reshape(B, C * ch, H, W).contiguous()


def from_library(t, C):
    """(B, C*ch, H, W) -> (C, B, H, W, ch), contiguous."""
    B, _, H, W = t.shape
    return t.reshape(B, C, -1, H, W).permute(1, 0, 3, 4, 2).contiguous()


def library_weights(w):
    """(C, 3, 3, I, O) -> the grouped convolution's (C*O, I, 3, 3)."""
    return w.permute(0, 4, 3, 1, 2).reshape(-1, w.shape[3], 3, 3).contiguous()


def library_conv3x3(x, w):
    """The library formulation on the port's layout: ``F.conv2d`` with one
    group per client between the two layout changes. Differentiable."""
    import torch.nn.functional as F

    C = x.shape[0]
    return from_library(F.conv2d(to_library(x), library_weights(w), padding=1,
                                 groups=C), C)


def library_backward(gl, xl, wl, groups, dgrad, wgrad):
    """One half (or both) of the grouped convolution's backward on tensors
    in the library's layout."""
    import torch

    return torch.ops.aten.convolution_backward(
        gl, xl, wl, None, [1, 1], [1, 1], [1, 1], False, [0, 0], groups,
        [dgrad, wgrad, False])


def conv_flops(x, w):
    """Operations of one direction of the 3x3 convolution of x (C, B, H, W,
    I) with w (C, 3, 3, I, O): 2 * 9 * I * O per output position. The two
    gradients do the same count."""
    C, B, H, W, I = x.shape
    return 2 * C * B * H * W * 9 * I * w.shape[-1]


def check_patch(cp, gen, C, B, shape, dtype):
    """K7's three products against their plain versions on one set of
    inputs, and the op through autograd against them."""
    import torch

    x, w, g = patch_inputs(gen, C, B, shape, dtype)
    H, W, I, O = shape
    tag = f"{str(dtype)[6:]} C={C} B={B} {H}x{W} {I}->{O}"
    w2 = w.reshape(C, 9 * I, O)
    y, y_ref = cp.patch_gemm_cuda(x, w2), cp.conv3x3_patch_plain(x, w2)
    dw, dw_ref = cp.patch_wgrad_cuda(x, g), cp.conv3x3_patch_wgrad_plain(x, g)
    wd = cp.dgrad_weights(w)
    dx, dx_ref = cp.patch_gemm_cuda(g, wd), cp.conv3x3_patch_plain(g, wd)
    torch.cuda.synchronize()
    err = {"fwd": check_rounded("K7 fwd", tag, y, y_ref, dtype),
           "wgrad": check_wgrad("K7 wgrad", tag, dw, dw_ref, B * H * W),
           "dgrad": check_rounded("K7 dgrad", tag, dx, dx_ref, dtype)}
    require(torch.equal(dw, cp.patch_wgrad_cuda(x, g)),
            f"K7 wgrad {tag}: two runs differ")
    # the launch plan's shared-memory count is the kernel library's own
    for kernel, i, o in (("gemm", I, O), ("gemm", O, I), ("wgrad", I, O)):
        plan = cp.launch_plan(kernel, dtype, C, B, H, W, i, o)
        got = cp.kernel_smem_bytes(plan, dtype, W, i, o)
        require(plan.route == cp.ROUTES[dtype] and plan.smem_bytes == got,
                f"K7 {tag}: plan {plan} against {got} B in the library")
    # the op: the same launches behind autograd, bit for bit
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = cp.conv3x3_patch(xr, wr)
    gx, gw = torch.autograd.grad(out, (xr, wr), g)
    torch.cuda.synchronize()
    require(torch.equal(out, y) and torch.equal(gx, dx)
            and torch.equal(gw, dw.reshape(w.shape).to(dtype)),
            f"K7 {tag}: conv3x3_patch through autograd differs from its "
            "own launches")
    return dict(err=err, x=x, w=w, g=g, w2=w2, wd=wd)


def phase_conv_patch(report):
    import torch
    import torch.nn.functional as F

    from fl_tpu_torch.ops import conv_patch as cp

    gen = torch.Generator(device="cuda").manual_seed(4)
    # the reference's test shapes, the stem's after space-to-depth, and
    # ragged ones (I, O and the row count no multiples of 4, of 8, of 16)
    small = ((2, (14, 14, 32, 64)), (2, (8, 8, 16, 16)), (1, (28, 28, 4, 8)),
             (2, S2D_STEM_SHAPE), (3, (5, 7, 3, 6)), (3, (5, 7, 20, 12)),
             (2, (14, 14, 48, 40)))
    n = 0
    routes = {}
    for dtype in (torch.float32, torch.bfloat16):
        before = dict(cp.ROUTE_LAUNCHES)
        for B, shape in small:
            check_patch(cp, gen, 3, B, shape, dtype)
            n += 1
        took = {k: v - before[k] for k, v in cp.ROUTE_LAUNCHES.items()
                if v != before[k]}
        require(list(took) == [cp.ROUTES[dtype]],
                f"K7 {dtype}: launches by route {took}")
        routes[str(dtype)[6:]] = took
    print(f"routes (K7): {routes} (launches in the small cases; the dtype "
          f"alone fixes the route)", flush=True)
    # the bench shapes in f32 (held to plain, not timed), then in bf16
    for shape in (S2D_STEM_SHAPE, CONV2_SHAPE):
        check_patch(cp, gen, NUM_CLIENTS, BATCH_SIZE, shape, torch.float32)
        torch.cuda.empty_cache()
    stem = check_patch(cp, gen, NUM_CLIENTS, BATCH_SIZE, S2D_STEM_SHAPE,
                       torch.bfloat16)
    stem_ms = (time_ms(lambda: cp.patch_gemm_cuda(stem["x"], stem["w2"])),
               time_ms(lambda: cp.patch_wgrad_cuda(stem["x"], stem["g"])))
    stem_err = stem["err"]
    del stem
    torch.cuda.empty_cache()

    big = check_patch(cp, gen, NUM_CLIENTS, BATCH_SIZE, CONV2_SHAPE,
                      torch.bfloat16)
    x, w, g, w2, wd = (big[k] for k in ("x", "w", "g", "w2", "wd"))
    C = NUM_CLIENTS
    xl, wl, gl = to_library(x), library_weights(w), to_library(g)
    # each direction reads two of x, w, dy and writes the third (dW in f32)
    flops = conv_flops(x, w)
    b_fwd, b_wgrad, b_dgrad = (bound(nbytes(x, w, g), flops),
                               bound(nbytes(x, g, w.float()), flops),
                               bound(nbytes(g, w, x), flops))
    report["conv3x3_patch_gemm"].update(
        max_abs_err=big["err"]["fwd"],
        ms=time_ms(lambda: cp.patch_gemm_cuda(x, w2)),
        plain_ms=time_ms(lambda: cp.conv3x3_patch_plain(x, w2)),
        library_ms=time_ms(lambda: F.conv2d(xl, wl, padding=1, groups=C)),
        bound_ms=b_fwd[0], bound_by=b_fwd[1])
    report["conv3x3_patch_gemm"]["dgrad"] = dict(
        max_abs_err=big["err"]["dgrad"],
        ms=time_ms(lambda: cp.patch_gemm_cuda(g, wd)),
        plain_ms=time_ms(lambda: cp.conv3x3_patch_plain(g, wd)),
        library_ms=time_ms(lambda: library_backward(gl, xl, wl, C, True,
                                                    False)),
        bound_ms=b_dgrad[0], bound_by=b_dgrad[1])
    report["conv3x3_patch_wgrad"].update(
        max_abs_err=big["err"]["wgrad"],
        ms=time_ms(lambda: cp.patch_wgrad_cuda(x, g)),
        plain_ms=time_ms(lambda: cp.conv3x3_patch_wgrad_plain(x, g)),
        library_ms=time_ms(lambda: library_backward(gl, xl, wl, C, False,
                                                    True)),
        bound_ms=b_wgrad[0], bound_by=b_wgrad[1])
    d = report["conv3x3_patch_gemm"]["dgrad"]
    share = {k: 1e3 * flops / e["ms"] / BF16_FLOPS for k, e in (
        ("fwd", report["conv3x3_patch_gemm"]), ("dgrad", d),
        ("wgrad", report["conv3x3_patch_wgrad"]))}
    print(f"kernels (K7): patch GEMM forward, weight gradient and input "
          f"gradient match plain in {n} small cases (f32 rtol 1e-4 / atol "
          f"1e-4, weight gradient atol 2e-4 growing with the rows summed; "
          f"bf16 one ulp + 1e-4) and at the bench's conv2 and s2d-stem "
          f"shapes in f32 and bf16 (bf16 max abs err fwd {big['err']['fwd']:.2e} wgrad "
          f"{big['err']['wgrad']:.2e} dgrad {big['err']['dgrad']:.2e}; stem "
          f"fwd {stem_err['fwd']:.2e} wgrad {stem_err['wgrad']:.2e}); the "
          f"weight gradient repeats bit for bit and conv3x3_patch through "
          f"autograd equals its launches bit for bit; the plan's "
          f"shared-memory bytes equal the library's count; input gradient "
          f"{d['ms']:.3f} ms, plain {d['plain_ms']:.3f}, "
          f"library {d['library_ms']:.3f}, bound {d['bound_ms']:.3f} "
          f"({d['bound_by']}); share of the bf16 tensor-core peak fwd "
          f"{share['fwd']:.3f} dgrad {share['dgrad']:.3f} wgrad "
          f"{share['wgrad']:.3f}; s2d stem 14x14 4->128: forward "
          f"{stem_ms[0]:.3f} ms, weight gradient {stem_ms[1]:.3f} ms",
          flush=True)
    torch.cuda.empty_cache()


def phase_conv_probe(report):
    import torch
    import torch.nn.functional as F

    from fl_tpu_torch.ops import conv_patch as cp
    from fl_tpu_torch.ops import conv_probe as probe

    gen = torch.Generator(device="cuda").manual_seed(5)
    n = 0
    routes, routes_b = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for C, M, K, N in PROBE_GEMM_SMALL[str(dtype)[6:]]:
            a = torch.randn((C, M, K), generator=gen, device="cuda").to(dtype)
            b = torch.randn((C, K, N), generator=gen, device="cuda").to(dtype)
            tag = f"{str(dtype)[6:]} {C}x{M}x{K}x{N}"
            before = dict(probe.ROUTE_LAUNCHES)
            got, want = probe.batched_gemm_cuda(a, b), (
                probe.batched_gemm_plain(a, b))
            torch.cuda.synchronize()
            check_rounded("K8a", tag, got, want, dtype)
            took = [k for k, v in probe.ROUTE_LAUNCHES.items()
                    if v != before[k]]
            plan = probe.launch_plan(dtype, C, M, K, N)
            lib_smem = probe.kernel_smem_bytes(plan, K, N)
            require(took == [plan.route] and plan.smem_bytes == lib_smem
                    and (plan.route == "cuda_core") == (dtype == torch.float32),
                    f"K8a {tag}: took {took}, plan {plan}, {lib_smem} B of "
                    "shared memory in the library")
            routes[tag] = plan.route
            n += 1
        for (B, shape), bf16_route in TAPLOOP_SMALL.items():
            x, w, _ = patch_inputs(gen, 3, B, shape, dtype)
            tag = f"{str(dtype)[6:]} B={B} {shape}"
            before = dict(probe.TAPLOOP_ROUTE_LAUNCHES)
            got, want = probe.taploop_conv_cuda(x, w), (
                probe.taploop_conv_plain(x, w))
            torch.cuda.synchronize()
            check_rounded("K8b", tag, got, want, dtype)
            took = [k for k, v in probe.TAPLOOP_ROUTE_LAUNCHES.items()
                    if v != before[k]]
            plan = probe.taploop_launch_plan(dtype, 3, B, *shape)
            lib_smem = probe.taploop_kernel_smem_bytes(plan, dtype, *shape)
            route = bf16_route if dtype == torch.bfloat16 else "cuda_core"
            require(took == [plan.route] == [route]
                    and plan.smem_bytes == lib_smem,
                    f"K8b {tag}: took {took}, plan {plan}, {lib_smem} B of "
                    "shared memory in the library")
            routes_b[tag] = plan.route
            n += 1

    # a bf16 view that starts 2 bytes past an allocation (K and N multiples
    # of 8, so the TMA route): batched_gemm copies it to an aligned one
    C, M, K, N = PROBE_GEMM_SMALL["bfloat16"][0]
    buf = torch.empty(1 + C * M * K, dtype=torch.bfloat16, device="cuda")
    buf[1:] = torch.randn(C * M * K, generator=gen, device="cuda")
    a = buf[1:].view(C, M, K)
    b = torch.randn((C, K, N), generator=gen, device="cuda").bfloat16()
    require(a.data_ptr() % 16 != 0, "F1: the view is aligned after all")
    check_rounded("K8a", "misaligned bf16 view", probe.batched_gemm(a, b),
                  probe.batched_gemm_plain(a, b), torch.bfloat16)
    del buf, a, b
    n += 1

    C, dt = NUM_CLIENTS, torch.bfloat16
    M, K, N = PROBE_GEMM_SHAPE
    # the bench shapes in f32 (held to plain, not timed), then in bf16
    x, w, _ = patch_inputs(gen, C, BATCH_SIZE, CONV2_SHAPE, torch.float32)
    check_rounded("K8b", "bench shapes f32", probe.taploop_conv_cuda(x, w),
                  probe.taploop_conv_plain(x, w), torch.float32)
    del x, w
    a = torch.randn((C, M, K), generator=gen, device="cuda")
    b = torch.randn((C, K, N), generator=gen, device="cuda")
    check_rounded("K8a", "bench shapes f32", probe.batched_gemm_cuda(a, b),
                  probe.batched_gemm_plain(a, b), torch.float32)
    del a, b
    torch.cuda.empty_cache()
    x, w, _ = patch_inputs(gen, C, BATCH_SIZE, CONV2_SHAPE, dt)
    plan_b = probe.taploop_launch_plan(dt, C, BATCH_SIZE, *CONV2_SHAPE)
    lib_smem = probe.taploop_kernel_smem_bytes(plan_b, dt, *CONV2_SHAPE)
    require(plan_b.route == "tma" and plan_b.smem_bytes == lib_smem,
            f"K8b at the bench shapes: plan {plan_b}, {lib_smem} B of shared "
            "memory in the library")
    before = dict(probe.TAPLOOP_ROUTE_LAUNCHES)
    y, y_ref = probe.taploop_conv_cuda(x, w), probe.taploop_conv_plain(x, w)
    torch.cuda.synchronize()
    took = {k: v - before[k] for k, v in probe.TAPLOOP_ROUTE_LAUNCHES.items()
            if v != before[k]}
    require(took == {"tma": 1}, f"K8b at the bench shapes: launches by "
                                f"route {took}")
    routes_b[f"bf16 B={BATCH_SIZE} {CONV2_SHAPE}"] = plan_b.route
    err_b = check_rounded("K8b", "bench shapes", y, y_ref, dt)
    # the tap loop and the patch GEMM both sum on the tensor cores, in their
    # own orders: the same f32 sum, rounded once
    y7 = cp.patch_gemm_cuda(x, w.reshape(C, 288, 64))
    check_rounded("K8b against K7", "bench shapes", y, y7, dt)
    gaps = {k: ulp_gap(y, other) for k, other in (("plain", y_ref),
                                                  ("K7", y7))}
    del y7
    xl, wl = to_library(x), library_weights(w)
    b_ms, b_by = bound(nbytes(x, w, y), conv_flops(x, w))
    report["probe_taploop_conv"].update(
        instruction=plan_b.instruction, max_abs_err=err_b,
        ms=time_ms(lambda: probe.taploop_conv_cuda(x, w)),
        plain_ms=time_ms(lambda: probe.taploop_conv_plain(x, w)),
        library_ms=time_ms(lambda: F.conv2d(xl, wl, padding=1, groups=C)),
        bound_ms=b_ms, bound_by=b_by)
    del x, w, y, y_ref, xl, wl
    torch.cuda.empty_cache()
    e = report["probe_taploop_conv"]
    print(f"routes (K8b): {routes_b} (the dtype and the shape fix the route: "
          f"bf16 on TMA + wgmma where I and O are multiples of 8 and the "
          f"ring fits; other bf16 shapes and f32 on the CUDA cores)",
          flush=True)
    print(f"kernels (K8b): bf16 at the bench shapes on route {plan_b.route} "
          f"({plan_b.stages} stages x {plan_b.blocks} blocks of "
          f"{plan_b.items_per_block} tiles) {e['ms']:.3f} ms, "
          f"{e['bound_ms'] / e['ms']:.3f} of its bound {e['bound_ms']:.3f} "
          f"({e['bound_by']}), library {e['library_ms']:.3f}, plain "
          f"{e['plain_ms']:.3f}; largest gap beyond 1e-4 / share of "
          f"bit-equal outputs: " + ", ".join(
              f"against {k} {g[0]:.2f} ulp / {g[1]:.4f}"
              for k, g in gaps.items()), flush=True)

    a = torch.randn((C, M, K), generator=gen, device="cuda", dtype=dt)
    b = torch.randn((C, K, N), generator=gen, device="cuda", dtype=dt)
    out, out_ref = probe.batched_gemm_cuda(a, b), (
        probe.batched_gemm_plain(a, b))
    torch.cuda.synchronize()
    err_a = check_rounded("K8a", "bench shapes", out, out_ref, dt)
    plan = probe.launch_plan(dt, C, M, K, N)
    routes[f"bf16 {C}x{M}x{K}x{N}"] = plan.route
    require(plan.route == "tma", f"K8a at the bench shapes: plan {plan}")
    b_ms, b_by = bound(nbytes(a, b, out), 2 * C * M * K * N)
    del out_ref
    report["probe_batched_gemm"].update(
        max_abs_err=err_a, ms=time_ms(lambda: probe.batched_gemm_cuda(a, b)),
        plain_ms=time_ms(lambda: probe.batched_gemm_plain(a, b), reps=2),
        library_ms=time_ms(lambda: torch.bmm(a, b)), bound_ms=b_ms,
        bound_by=b_by)
    del a, b, out
    torch.cuda.empty_cache()
    print(f"routes (K8a): {routes} (the dtype and the shape fix the route: "
          f"bf16 on TMA + wgmma where K and N are multiples of 8, else "
          f"staged + wgmma; f32 on the CUDA cores)", flush=True)
    e = report["probe_batched_gemm"]
    print(f"kernels (K8): batched GEMM and tap-loop conv match plain in {n} "
          f"small cases, ragged ones among them (f32 rtol 1e-4 / atol 1e-4; "
          f"bf16 one ulp + 1e-4), and at the bench shapes in f32 and bf16 "
          f"(bf16 max abs err GEMM "
          f"{err_a:.2e}, tap loop {err_b:.2e}); tap loop against patch "
          f"GEMM forward at the bench shapes within one bf16 ulp + 1e-4; "
          f"bf16 GEMM at the bench shapes "
          f"{e['ms']:.3f} ms on {plan.stages} stages x {plan.blocks} blocks, "
          f"torch.bmm {e['library_ms']:.3f}, {e['bound_ms'] / e['ms']:.3f} of "
          f"its bound ({e['bound_by']}), "
          f"{1e3 * nbytes_gemm(C, M, K, N) / e['ms'] / 1e12:.2f} TB/s",
          flush=True)


def _frob(name, got, want, tol=FORMULATION_TOL):
    """Hold one formulation's tensors to the library's, each to `tol` in
    relative Frobenius norm; returns the largest distance."""
    worst = max(_rel(a, b) for a, b in zip(got, want))
    require(worst <= tol, f"formulations, {name}: {worst} from the library "
                          f"result in relative Frobenius norm (tol {tol})")
    return worst


def conv_formulations(card, C=NUM_CLIENTS, B=BATCH_SIZE, reps=5):
    """The conv-formulations measurement at the bench shapes in bf16: the
    same convolution computed by the library, as nine shifted GEMMs, as one
    patch GEMM, as a tap loop and as a bare GEMM on a prebuilt patch matrix;
    and the stem as library chain and as space-to-depth patch GEMM. Each
    formulation is held to the library result, then timed (CUDA events,
    `reps` calls after a warm one). Returns (rows, launches): rows of
    (group, formulation, what, ms, distance from the library) and the K7/K8
    launch counts of the whole measurement, which are checked here against
    the calls made: one patch GEMM per forward, one more per input
    gradient, one weight-gradient launch per backward, none of an input
    gradient for the stem."""
    import torch
    import torch.nn.functional as F

    from fl_tpu_torch import ops
    from fl_tpu_torch.ops.conv import conv3x3_same
    from fl_tpu_torch.ops.conv_patch import conv3x3_patch, conv_stem_s2d
    from fl_tpu_torch.ops.conv_probe import batched_gemm, taploop_conv

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    start = before = ops.launch_counts()

    def launched():
        now = ops.launch_counts()
        return {k: now[k] - before[k] for k in FORMULATION_KERNELS}

    def expect(section, **want):
        got = launched()
        want = {**dict.fromkeys(FORMULATION_KERNELS, 0), **want}
        require(got == want, f"formulations, {section}: launches {got}, "
                             f"expected {want}")

    timed = reps + 1   # calls of one time_ms

    # --- conv2 14x14 32->64 ---
    x, w, g = patch_inputs(gen, C, B, CONV2_SHAPE, dt)
    xl, wl, gl = to_library(x), library_weights(w), to_library(g)

    def fwd_bwd(fn):
        def run():
            xr, wr = x.detach().requires_grad_(True), (
                w.detach().requires_grad_(True))
            y = fn(xr, wr)
            return (y.detach(),) + torch.autograd.grad(y, (xr, wr), g)
        return run

    def own_layout():
        xr, wr = xl.detach().requires_grad_(True), (
            wl.detach().requires_grad_(True))
        return torch.autograd.grad(F.conv2d(xr, wr, padding=1, groups=C),
                                   (xr, wr), gl)

    want = fwd_bwd(library_conv3x3)()
    variants = (("library, F.conv2d groups=clients, between layout changes",
                 library_conv3x3),
                ("shift-GEMM, conv3x3_same", conv3x3_same),
                ("patch GEMM, conv3x3_patch (K7)", conv3x3_patch))
    group = "conv2 14x14 32->64"
    with torch.no_grad():
        rows.append((group, "library, F.conv2d in its own layout", "fwd",
                     time_ms(lambda: F.conv2d(xl, wl, padding=1, groups=C),
                             reps), None))
    rows.append((group, "library, F.conv2d in its own layout", "fwd+bwd",
                 time_ms(own_layout, reps), None))
    for name, fn in variants:
        dist = (None if fn is library_conv3x3 else
                _frob(f"{group}, {name}", fwd_bwd(fn)(), want))
        with torch.no_grad():
            rows.append((group, name, "fwd", time_ms(lambda: fn(x, w), reps),
                         dist))
        rows.append((group, name, "fwd+bwd", time_ms(fwd_bwd(fn), reps),
                     dist))
    expect("conv2", conv3x3_patch_gemm=2 + timed + 2 * timed,
           conv3x3_patch_wgrad=1 + timed)

    # --- probes: the tap loop on the same inputs, the bare GEMM ---
    group = "probes"
    dist = _frob("tap loop", (taploop_conv(x, w),), want[:1])
    rows.append((group, "tap loop, taploop_conv (K8b)", "fwd",
                 time_ms(lambda: taploop_conv(x, w), reps), dist))
    del x, w, g, xl, wl, gl, want
    torch.cuda.empty_cache()
    M, K, N = PROBE_GEMM_SHAPE
    a = torch.randn((C, M, K), generator=gen, device="cuda", dtype=dt)
    b = torch.randn((C, K, N), generator=gen, device="cuda", dtype=dt)
    dist = _frob("bare GEMM", (batched_gemm(a, b),), (torch.bmm(a, b),))
    rows.append((group, f"library, torch.bmm ({M}x{K} @ {K}x{N})", "fwd",
                 time_ms(lambda: torch.bmm(a, b), reps), None))
    rows.append((group, "bare GEMM on a prebuilt patch matrix, batched_gemm "
                 "(K8a)", "fwd", time_ms(lambda: batched_gemm(a, b), reps),
                 dist))
    del a, b
    torch.cuda.empty_cache()
    expect("conv2 and probes", conv3x3_patch_gemm=2 + 3 * timed,
           conv3x3_patch_wgrad=1 + timed, probe_taploop_conv=1 + timed,
           probe_batched_gemm=1 + timed)
    before = ops.launch_counts()

    # --- stem 28x28 1->32 + relu + pool ---
    group = "stem 28x28 1->32 + relu + pool"
    x = torch.randn((C, B, 28, 28, 1), generator=gen, device="cuda").to(dt)
    w = (torch.randn((C, 3, 3, 1, 32), generator=gen, device="cuda")
         * 0.3).to(dt)
    bias = (torch.randn((C, 32), generator=gen, device="cuda") * 0.1).to(dt)
    g = torch.randn((C, B, 14, 14, 32), generator=gen, device="cuda").to(dt)

    def library_stem(x, w, b):
        y = F.conv2d(to_library(x), library_weights(w), padding=1, groups=C)
        y = F.max_pool2d(torch.relu(y + b.reshape(1, -1, 1, 1)), 2)
        return from_library(y, C)

    def stem_grads(fn):
        def run():
            wr, br = w.detach().requires_grad_(True), (
                bias.detach().requires_grad_(True))
            y = fn(x, wr, br)
            return (y.detach(),) + torch.autograd.grad(y, (wr, br), g)
        return run

    want = stem_grads(library_stem)()
    got = stem_grads(conv_stem_s2d)()
    # values to the formulations' tolerance; gradients to the looser one: a
    # bf16 pool window ties often, and the library's pool sends a tie's
    # gradient to the first member where the parity-group max shares it
    dist = (_frob(f"{group}, values", got[:1], want[:1]),
            _frob(f"{group}, gradients", got[1:], want[1:],
                  FORMULATION_GRAD_TOL))
    for name, fn, d in (("library chain: F.conv2d, bias, relu, F.max_pool2d",
                         library_stem, None),
                        ("space-to-depth patch GEMM, conv_stem_s2d (K7)",
                         conv_stem_s2d, dist)):
        with torch.no_grad():
            rows.append((group, name, "fwd",
                         time_ms(lambda: fn(x, w, bias), reps),
                         d and d[0]))
        rows.append((group, name, "fwd+(w,b) grads",
                     time_ms(stem_grads(fn), reps), d and d[1]))
    # one patch GEMM per forward and not one more: the stem's input gradient
    # is never launched
    expect("stem", conv3x3_patch_gemm=1 + 2 * timed,
           conv3x3_patch_wgrad=1 + timed)
    del x, w, bias, g, want, got
    torch.cuda.empty_cache()

    for grp, name, what, ms, d in rows:
        print(f"formulations [{grp}] {name}: {what} {ms:.3f} ms"
              + ("" if d is None else f", {d:.2e} from the library result")
              + f" [{card}]", flush=True)
    now = ops.launch_counts()
    return rows, {k: now[k] - start[k] for k in FORMULATION_KERNELS}


def check_pool_first_match():
    """F.max_pool2d's backward on the card sends a tied window's gradient
    to its first member, as the fused kernels and XLA do."""
    import torch
    import torch.nn.functional as F

    from fl_tpu_torch.ops.conv_block import _unpool

    for dtype in (torch.float32, torch.bfloat16):
        t = torch.ones((2, 8, 6, 6), device="cuda", dtype=dtype,
                       requires_grad=True)
        g = torch.arange(2 * 8 * 3 * 3, device="cuda").reshape(2, 8, 3, 3)
        g = g.to(dtype) + 1
        got, = torch.autograd.grad(F.max_pool2d(t, 2), t, g)
        want = _unpool(g.float(), torch.zeros_like(g, dtype=torch.uint8),
                       6, 6)
        require(torch.equal(got.float(), want),
                f"F.max_pool2d backward in {dtype} does not route ties to "
                "the first window member")


def bench_arrays():
    """The bench's 512 IID shards of 64 synthetic MNIST images (host)."""
    from fl_tpu_torch.data import load_dataset, make_federated_arrays

    splits = load_dataset("mnist",
                          n_train_synth=NUM_CLIENTS * SAMPLES_PER_CLIENT,
                          n_test_synth=1024)
    return make_federated_arrays(splits, num_clients=NUM_CLIENTS,
                                 strategy="iid",
                                 samples_per_client=SAMPLES_PER_CLIENT,
                                 seed=0)


def bench_training():
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig

    return FederatedTrainingConfig(
        local_epochs=LOCAL_EPOCHS, batch_size=BATCH_SIZE,
        learning_rate=0.001, optimizer_state_dtype="bfloat16")


def bench_model(fused="residual"):
    import torch

    from fl_tpu_torch.models import create_model

    return create_model("simple_cnn", dtype=torch.bfloat16,
                        fused_conv_block=fused)


def make_bench_engine(fused, **compression):
    """The engine of the 512-client bf16 delta-DP configuration (bench.py's
    workload) with one conv formulation; ``compression`` takes
    RoundEngineConfig's uplink and downlink fields."""
    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    cfg = RoundEngineConfig(
        training=bench_training(),
        dp_mode="delta",
        privacy=PrivacyConfig(epsilon=1.0, delta=1e-5, max_grad_norm=1.0),
        epsilon_per_round=EPS_R, delta_per_round=DELTA_R,
        max_clients=NUM_CLIENTS, seed=0, **compression)
    return FederatedRoundEngine(bench_model(fused), bench_arrays(), cfg,
                                device=DEVICE)


def bench_engine(card, fused, rounds, conv_counts, **compression):
    """The 512-client bf16 delta-DP round with one conv formulation, and
    with ``compression`` if given: a warm-up round, then `rounds` pipelined
    rounds whose launch counts must be `conv_counts` per local step plus
    K3's 2 a round, and 0 elsewhere. Where an uplink is on, every round's
    error-feedback norm must be finite and non-zero. Returns the counts,
    the engine's uplink state and its global parameters."""
    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.ops import conv_block as cb

    engine = make_bench_engine(fused, **compression)
    t0 = time.perf_counter()
    warm = engine.run_round(evaluate=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run_rounds_pipelined(rounds, evaluate=False)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()

    losses = [warm.train_loss] + [r.train_loss for r in results]
    require(len(results) == rounds, "pipelined rounds missing")
    require(all(math.isfinite(v) for v in losses), f"losses {losses}")
    steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
    want = dict.fromkeys(counts, 0)
    want.update({k: steps * rounds for k in conv_counts},
                clip_noise=2 * rounds)
    require(counts == want, f"fused_conv_block={fused!r}: launch counts "
                            f"{counts}, expected {want}")
    # the bf16 model's fused kernels all took the tensor-core route
    require(all(cb.ROUTE_LAUNCHES[(k, "tensor_core")] == counts[k]
                for k in conv_counts),
            f"fused_conv_block={fused!r}: launches by route "
            f"{ {k: v for k, v in cb.ROUTE_LAUNCHES.items() if v} }")
    params = engine.global_variables["params"]
    require(all(bool(torch.isfinite(t).all())
                for d in params.values() for t in d.values()),
            "non-finite global parameters")
    require(np.isfinite(engine.last_client_losses).all(),
            "non-finite client losses")
    ef_norms = [r.uplink_ef_norm for r in [warm] + results]
    if compression.get("uplink_compression", "none") != "none":
        require(all(v is not None and math.isfinite(v) and v > 0
                     for v in ef_norms), f"{compression}: EF norms {ef_norms}")
        ef_text = f", EF norm by round {[round(v, 2) for v in ef_norms]}"
    else:
        require(ef_norms == [None] * len(ef_norms), f"EF norms {ef_norms}")
        ef_text = ""
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    used = {k: v for k, v in counts.items() if v}
    label = "".join(f" {k}={v!r}" for k, v in compression.items())
    print(f"slice fused_conv_block={fused!r}{label}: {NUM_CLIENTS} clients "
          f"bf16 delta-DP, warm-up round {warm_s:.2f}s, {rounds} pipelined "
          f"rounds in {dt:.3f}s -> {rounds / dt:.3f} rounds/s, peak memory "
          f"{peak:.2f} GiB, losses {[round(v, 4) for v in losses]}"
          f"{ef_text}, launches {used} (0 elsewhere), eps spent "
          f"{engine.budget_tracker.consumed_epsilon:.4f} [{card}]",
          flush=True)
    out = (counts, engine.uplink_error, engine.global_variables["params"])
    del engine
    torch.cuda.empty_cache()
    return out


def entry_points(counts):
    """K5 and K6 through the entry points a user calls, at full width, with
    the counts set to 0 just before and read just after."""
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.ops.conv_block import conv_stack_packed
    from fl_tpu_torch.ops.quantize import dequantize_int8_blocks, quantize_int8

    gen = torch.Generator(device="cuda").manual_seed(3)
    x, *ws = conv_inputs(gen, NUM_CLIENTS, BATCH_SIZE, torch.bfloat16)
    ws = [t.requires_grad_(True) for t in ws]
    ops.reset_launch_counts()
    out = conv_stack_packed(x, *ws)
    grads = torch.autograd.grad(out.float().square().sum(), ws)
    torch.cuda.synchronize()
    got = ops.launch_counts()
    want = dict.fromkeys(got, 0)
    want.update(conv_stack_fwd=1, conv_stack_bwd=1)
    require(got == want, f"conv_stack_packed did not go through K4's two "
                         f"kernels and nothing else: {got}")
    require(tuple(out.shape) == (NUM_CLIENTS, BATCH_SIZE, 7, 7, 64)
            and all(bool(torch.isfinite(t).all()) for t in (out, *grads)),
            "conv_stack_packed: non-finite output or gradients")
    counts["conv_stack_packed"] = (got["conv_stack_fwd"]
                                   + got["conv_stack_bwd"])
    del x, ws, out, grads

    deltas = torch.randn((quantize_width(),), generator=gen,
                         device="cuda") * 1e-3
    ops.reset_launch_counts()
    q, scales = quantize_int8(deltas, seed=9)
    torch.cuda.synchronize()
    got = ops.launch_counts()
    require(got["quantize_int8_blocks"] == 1,
            f"quantize_int8 did not launch K6: {got}")
    err = (dequantize_int8_blocks(q, scales) - deltas).reshape(
        scales.shape[0], -1).abs().amax(1)
    require(q.dtype == torch.int8 and bool((err < scales).all()),
            "quantize_int8: a value is a whole step or more off")
    counts["quantize_int8_blocks"] = got["quantize_int8_blocks"]
    print(f"entry points: conv_stack_packed at P={NUM_CLIENTS} x "
          f"{BATCH_SIZE} bf16 through K4 (fwd 1, bwd 1); quantize_int8 at "
          f"D={deltas.numel()} through K6, every error under one step",
          flush=True)


def _host_rows(t):
    return t[COMPRESSION_ROWS].cpu()


def check_uplink_ops(card, mat, psgd_state, params):
    """The uplink round trips on the card held to the port's CPU functions
    on the same values: COMPRESSION_ROWS of a real (512, D_pad) matrix
    copied to the host. int8 bit for bit; top-k the same kept set and
    values, never a lane-padding column; PowerSGD's reconstruction and new Q
    within rtol 1e-5 and atol 1e-6 times the row's largest magnitude (an
    absolute 1e-6 is below one f32 ulp of these values; the CPU's own f32
    error against f64 is printed beside the card's). Each op is timed on
    the whole matrix."""
    import torch

    from fl_tpu_torch.fl import powersgd as ps
    from fl_tpu_torch.fl import uplink as up

    cpu = _host_rows(mat)
    got = up.int8_roundtrip_matrix(mat)
    require(torch.equal(_host_rows(got), up.int8_roundtrip_matrix(cpu)),
            "int8 round trip: the card differs from the CPU")
    k = round(N_PARAMS * TOPK_RATIO)
    got = up.topk_roundtrip_matrix(mat, k)
    want = up.topk_roundtrip_matrix(cpu, k)
    kept = _host_rows(got) != 0
    require(bool((kept == (want != 0)).all())
            and int(kept.sum()) == k * len(cpu)
            and torch.equal(_host_rows(got)[kept], want[kept]),
            "top-k: the card keeps another set than the CPU")
    require(not bool(got[:, N_PARAMS:].any()),
            "top-k kept a lane-padding column")

    plan = ps.make_powersgd_plan(params, POWERSGD_RANK)
    q = psgd_state[:, plan.d_pad:]
    out, qn = ps.powersgd_roundtrip(mat, q, plan)
    want = ps.powersgd_roundtrip(cpu, _host_rows(q), plan)
    exact = ps.powersgd_roundtrip(cpu.double(), _host_rows(q).double(), plan)
    gaps = []
    for name, g, w, x in (("reconstruction", out, want[0], exact[0]),
                          ("new Q", qn, want[1], exact[1])):
        g = _host_rows(g)
        scale = w.abs().amax(1, keepdim=True)
        require(bool(((g - w).abs() <= 1e-6 * scale + 1e-5 * w.abs()).all()),
                f"PowerSGD {name}: the card differs from the CPU by "
                f"{float(((g - w).abs() / scale).max()):.2e} of a row's "
                "largest value")
        # elements outside an absolute 1e-6 + rtol 1e-5: the card against
        # the CPU, and the CPU's own f32 result against f64
        x = x.float()
        miss = [int(((a - b).abs() > 1e-6 + 1e-5 * b.abs()).sum())
                for a, b in ((g, w), (w, x))]
        gaps.append(f"{name}: card-CPU "
                    f"{float(((g - w).abs() / scale).max()):.2e} and CPU-f64 "
                    f"{float(((w - x).abs() / scale).max()):.2e} of a row's "
                    f"largest value; outside 1e-6 + 1e-5|x|: card-CPU "
                    f"{miss[0]}, CPU-f64 {miss[1]} of {w.numel()}")
    del got, out, qn

    alive = torch.ones(mat.shape[0], device=mat.device)
    ms = {
        "int8": time_ms(lambda: up.int8_roundtrip_matrix(mat)),
        "topk": time_ms(lambda: up.topk_roundtrip_matrix(mat, k)),
        "powersgd": time_ms(lambda: ps.powersgd_roundtrip(mat, q, plan)),
        "int8 EF step": time_ms(lambda: up.apply_uplink_with_error_feedback(
            mat, mat, alive, up.int8_roundtrip_matrix)),
    }
    print(f"uplink on the card vs the CPU ({len(cpu)} rows of the "
          f"{tuple(mat.shape)} matrix): int8 bit-equal, top-k the same "
          f"{k} kept a row, PowerSGD rank {POWERSGD_RANK} "
          f"({' | '.join(gaps)}); ms on the whole "
          "matrix: " + ", ".join(f"{n} {t:.3f}" for n, t in ms.items())
          + f" [{card}]", flush=True)


def check_wire(params):
    """The real global model through the wire codecs and back, each within
    its stated error: lz4 (the native codec) lossless, quantization within
    0.51 of a step per tensor, top-k its kept entries exact and no dropped
    |x| above a kept one."""
    import numpy as np

    from fl_tpu_torch.fl.compression import create_compression_service
    from fl_tpu_torch.models import params_to_flax

    weights = {f"{l}/{k}": v for l, leaves in params_to_flax(params).items()
               for k, v in leaves.items()}
    parts = []
    for algo in ("lz4", "quantization", "top_k"):
        svc = create_compression_service(algo)
        t0 = time.perf_counter()
        payload, meta = svc.compress_weights(weights)
        back = svc.decompress_weights(payload, meta)
        dt = time.perf_counter() - t0
        for name, w in weights.items():
            b = back[name]
            require(b.shape == w.shape and b.dtype == w.dtype,
                    f"{algo}: {name} came back as {b.shape} {b.dtype}")
            if algo == "lz4":
                require(meta["backend"] == "native" and np.array_equal(b, w),
                        f"lz4 ({meta['backend']}): {name} not restored")
            elif algo == "quantization":
                step = meta["tensors"][name]["scale"]
                require(float(np.abs(b - w).max()) <= 0.51 * step + 1e-7,
                        f"quantization: {name} off by more than half a step")
            else:
                kept = b != 0
                k = max(1, round(w.size * (1 - meta["sparsity_ratio"])))
                require(int(kept.sum()) == k
                        and np.array_equal(b[kept], w[kept])
                        and np.abs(w[kept]).min() >= np.abs(w[~kept]).max(),
                        f"top_k: {name} did not keep its {k} largest "
                        "entries")
        parts.append(f"{algo} ratio {meta['compression_ratio']:.4f} "
                     f"({dt:.2f}s)")
    print(f"wire: the global model ({N_PARAMS} values) through "
          + ", ".join(parts) + "; lz4 on the native codec", flush=True)


def phase_compression(card):
    """The compressed bench rounds (uplink int8 / top-k / PowerSGD,
    downlink bf16 / int8, downlink int8 + uplink top-k), each with K1/K2/K3
    launched as on the uncompressed path; then the uplink ops on the card
    held to the CPU, and the wire codecs on the real global model."""
    import torch

    states = {}
    for compression in COMPRESSED_ENGINES:
        _, state, params = bench_engine(
            card, "residual", COMPRESSED_ROUNDS,
            ("conv_block_fwd", "conv_block_bwd"), **compression)
        # kept on the host, out of the next engines' peak memory
        kind = compression.get("uplink_compression")
        if kind in ("topk", "powersgd") and kind not in states:
            states[kind] = state.cpu()
        del state
    # the top-k engine's error feedback: dense DP-noised deltas less what
    # they sent, zero in the lane padding
    check_uplink_ops(card, states["topk"].to(DEVICE),
                     states["powersgd"].to(DEVICE), params)
    del states
    torch.cuda.empty_cache()
    check_wire(params)


def central_dp_config(**overrides):
    """RoundEngineConfig of the client_dp bench rounds."""
    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.orchestration import RoundEngineConfig

    return RoundEngineConfig(
        training=bench_training(), dp_mode="client_dp",
        privacy=PrivacyConfig(epsilon=CDP_EPSILON, delta=CDP_DELTA,
                              max_grad_norm=CDP_CLIP,
                              noise_multiplier=CDP_Z),
        participation_rate=CDP_RATE, max_clients=NUM_CLIENTS, seed=0,
        **overrides)


def central_dp_engine(**overrides):
    from fl_tpu_torch.orchestration import FederatedRoundEngine

    return FederatedRoundEngine(bench_model(), bench_arrays(),
                                central_dp_config(**overrides),
                                device=DEVICE)


def check_cdp_launches(label, counts, rounds):
    """K1/K2 on the tensor cores 10 times a round, nothing else (no K3:
    client_dp adds no per-client noise)."""
    from fl_tpu_torch.ops import conv_block as cb

    steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
    want = dict.fromkeys(counts, 0)
    want.update(conv_block_fwd=steps * rounds, conv_block_bwd=steps * rounds)
    require(counts == want, f"{label}: launch counts {counts}, expected "
                            f"{want}")
    require(all(cb.ROUTE_LAUNCHES[(k, "tensor_core")] == want[k]
                for k in ("conv_block_fwd", "conv_block_bwd")),
            f"{label}: launches by route "
            f"{ {k: v for k, v in cb.ROUTE_LAUNCHES.items() if v} }")


def check_cdp_rounds(label, engine, results, clips=None):
    """Each round's participants are the pure Poisson draw of the engine's
    numpy stream, its σ is z·C/m̄ (z_Δ when adaptive), and its ε is a fresh
    RDP accountant's stepped at (q, z) once a round, bit for bit."""
    import numpy as np
    import torch

    from fl_tpu_torch.fl.accounting import RDPAccountant

    rng = np.random.default_rng(1)   # the engine's stream, seed + 1
    fresh = RDPAccountant()
    ledger = engine.accountant.get_privacy_ledger()
    require(len(ledger) == len(results), f"{label}: ledger {len(ledger)}")
    m_bar = CDP_RATE * NUM_CLIENTS
    z = engine._z_delta if engine.config.adaptive_clipping else CDP_Z
    eps = []
    for i, (r, entry) in enumerate(zip(results, ledger)):
        drawn = int((rng.random(NUM_CLIENTS) < CDP_RATE).sum())
        require(r.participating_clients == drawn,
                f"{label}: round {i} had {r.participating_clients} "
                f"participants, the Poisson draw {drawn}")
        c = CDP_CLIP if clips is None else clips[i]
        require(abs(entry["noise_scale"] / (z * c / m_bar) - 1) < 1e-6,
                f"{label}: round {i} σ {entry['noise_scale']}, expected "
                f"{z * c / m_bar}")
        fresh.step(CDP_RATE, CDP_Z)
        want = fresh.get_epsilon(CDP_DELTA)
        require(entry["metadata"]["total_epsilon"] == want,
                f"{label}: ε after round {i} "
                f"{entry['metadata']['total_epsilon']}, the RDP "
                f"accountant's {want}")
        eps.append(want)
    require(all(math.isfinite(r.train_loss) for r in results),
            f"{label}: losses {[r.train_loss for r in results]}")
    params = engine.global_variables["params"]
    require(all(bool(torch.isfinite(t).all())
                for d in params.values() for t in d.values()),
            f"{label}: non-finite global parameters")
    return ([r.participating_clients for r in results],
            [entry["noise_scale"] for entry in ledger], eps)


def check_cdp_functions(card):
    """clip_client_deltas + the fixed-m̄ masked mean, and the engine's
    fused form of it, on a (512 x SimpleCNN) stacked tree held to f64 on
    the host; central_noise_tree on the global model's leaves by its
    distribution."""
    import numpy as np
    import torch
    from scipy import stats

    from fl_tpu_torch.core import prng
    from fl_tpu_torch.core.pytree import tree_map, tree_paths
    from fl_tpu_torch.fl import privacy as dp

    engine_params = bench_model().init(
        prng.generator(prng.root_seed(2), DEVICE), DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    # norms spread over 0.1..10 x C, so about half the clients are clipped
    spread = torch.logspace(-1, 1, NUM_CLIENTS, device=DEVICE)
    tree = tree_map(lambda p: torch.randn(
        (NUM_CLIENTS,) + tuple(p.shape), generator=gen, device=DEVICE),
        engine_params)
    norms0 = dp.client_norms(tree)
    tree = tree_map(lambda d: d * (spread / norms0).reshape(
        (-1,) + (1,) * (d.dim() - 1)), tree)
    mask = (torch.rand(NUM_CLIENTS, generator=gen, device=DEVICE)
            < CDP_RATE).float()
    m_bar = CDP_RATE * NUM_CLIENTS

    clipped, norms = dp.clip_client_deltas(tree, CDP_CLIP)
    literal = tree_map(lambda d: torch.tensordot(mask, d, dims=1) / m_bar,
                       clipped)
    del clipped
    fused, norms_f = dp.clipped_masked_mean(tree, CDP_CLIP, mask, m_bar)
    mask64 = mask.double().cpu()
    norms64 = torch.sqrt(sum(tree[l][k].double().cpu().reshape(
        NUM_CLIENTS, -1).square().sum(1) for l, k in tree_paths(tree)))
    scale64 = torch.clamp(CDP_CLIP / norms64, max=1.0)
    worst = {"norms": float(((norms.double().cpu() - norms64).abs()
                             / norms64).max()),
             "fused norms": float(((norms_f.double().cpu() - norms64).abs()
                                   / norms64).max())}
    for l, k in tree_paths(tree):
        want = torch.tensordot(mask64 * scale64,
                               tree[l][k].double().cpu(), dims=1) / m_bar
        for name, got in (("literal", literal), ("fused", fused)):
            err = float(torch.linalg.vector_norm(
                got[l][k].double().cpu() - want)
                / torch.linalg.vector_norm(want))
            worst[name] = max(worst.get(name, 0.0), err)
    require(all(v <= CDP_MEAN_TOL for v in worst.values()),
            f"client_dp clip + mean against f64: {worst}")
    ms_literal = time_ms(lambda: dp.clip_client_deltas(tree, CDP_CLIP))
    ms_fused = time_ms(lambda: dp.clipped_masked_mean(tree, CDP_CLIP, mask,
                                                      m_bar))
    del tree, literal, fused

    sigma = CDP_Z * CDP_CLIP / m_bar
    noisy = dp.central_noise_tree(engine_params, 12345, sigma)
    res = {f"{l}/{k}": ((noisy[l][k] - engine_params[l][k]).double()
                        / sigma).cpu().numpy().ravel()
           for l, k in tree_paths(engine_params)}
    z = np.concatenate(list(res.values()))
    n = z.size
    ks = stats.kstest(z, "norm").pvalue
    a, b = res["fc1/kernel"], res["conv2/kernel"]
    r = float(np.corrcoef(a[:b.size], b)[0, 1])
    require(abs(z.mean()) < 5 / math.sqrt(n)
            and abs(z.var() - 1) < 5 * math.sqrt(2 / n) and ks > 1e-3
            and abs(r) < 5 / math.sqrt(b.size),
            f"central noise at σ={sigma}: mean {z.mean()}, var {z.var()}, "
            f"KS p {ks}, corr(fc1, conv2) {r}")
    print(f"central_dp functions: clip_client_deltas + fixed-m̄ mean on "
          f"({NUM_CLIENTS} x {N_PARAMS}) f32 against f64, worst relative "
          f"error {', '.join(f'{k} {v:.2e}' for k, v in worst.items())} "
          f"(tol {CDP_MEAN_TOL}); clip_client_deltas {ms_literal:.3f} ms, "
          f"clipped_masked_mean {ms_fused:.3f} ms; central_noise_tree at "
          f"σ={sigma:.6f} over {n} values: mean {z.mean():.2e}, var "
          f"{z.var():.5f}, KS p {ks:.3f}, corr(fc1, conv2) {r:.2e} "
          f"[{card}]", flush=True)


def phase_central_dp(card):
    """Client-level DP-FedAvg on the 512-client bench round: pipelined
    rounds under the RDP accountant, the PLD gate, adaptive clipping, the
    update-canary audit at full width, and the plain functions of the path
    held on the card. Returns the launch counts of the pipelined rounds."""
    import copy

    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.fl.accounting import rdp_subsampled_gaussian
    from fl_tpu_torch.fl.pld import compute_epsilon_pld
    from fl_tpu_torch.validation.audit import run_client_membership_audit

    # client_dp, pipelined, RDP
    engine = central_dp_engine()
    t0 = time.perf_counter()
    warm = engine.run_round(evaluate=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run_rounds_pipelined(CDP_ROUNDS, evaluate=False)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_cdp_launches("client_dp", counts, CDP_ROUNDS)
    parts, sigmas, eps = check_cdp_rounds("client_dp", engine,
                                          [warm] + results)
    # host accounting of a dispatch: the gate's projection and the charge,
    # with the per-round RDP vector computed once at init
    reps = 200
    t1 = time.perf_counter()
    for _ in range(reps):
        engine._client_dp_gate()
    gate_ms = (time.perf_counter() - t1) * 1e3 / reps
    acc = copy.deepcopy(engine.rdp_accountant)
    t1 = time.perf_counter()
    for _ in range(reps):
        acc.get_epsilon(CDP_DELTA)
        acc.accumulate(engine._round_rdp)
        acc.get_epsilon(CDP_DELTA)
    charge_ms = (time.perf_counter() - t1) * 1e3 / reps
    t1 = time.perf_counter()
    for _ in range(20):
        rdp_subsampled_gaussian(CDP_RATE, CDP_Z)
    rdp_ms = (time.perf_counter() - t1) * 1e3 / 20
    print(f"central_dp client_dp pipelined: {NUM_CLIENTS} clients bf16 "
          f"q={CDP_RATE} z={CDP_Z} C={CDP_CLIP} (ε, δ)=({CDP_EPSILON}, "
          f"{CDP_DELTA}) rdp, warm-up round {warm_s:.2f}s, {CDP_ROUNDS} "
          f"pipelined rounds in {dt:.3f}s -> {CDP_ROUNDS / dt:.3f} "
          f"rounds/s, peak memory {peak:.2f} GiB, participants by round "
          f"{parts}, σ by round {[round(v, 6) for v in sigmas]}, ε by "
          f"round {[round(v, 4) for v in eps]} (= the RDP accountant's), "
          f"launches K1/K2 "
          f"{counts['conv_block_fwd']}/{counts['conv_block_bwd']}, K3 "
          f"{counts['clip_noise']}; host accounting a dispatch: gate "
          f"{gate_ms:.3f} ms + charge {charge_ms:.3f} ms (one "
          f"rdp_subsampled_gaussian call {rdp_ms:.3f} ms) [{card}]",
          flush=True)
    del engine, results
    torch.cuda.empty_cache()

    # the PLD gate: its step budget at first use, then one round
    engine = central_dp_engine(accountant="pld")
    t1 = time.perf_counter()
    budget = engine._pld_step_budget()
    pld_s = time.perf_counter() - t1
    r = engine.run_round(evaluate=False)
    cert = engine.certified_epsilon()
    want = compute_epsilon_pld(1, CDP_RATE, CDP_Z, CDP_DELTA)
    require(budget > 1 and cert == want and cert <= CDP_EPSILON
            and math.isfinite(r.train_loss),
            f"pld: budget {budget}, certified {cert} (want {want})")
    print(f"central_dp pld: step budget {budget} rounds at ε={CDP_EPSILON} "
          f"(doubling + bisection, {pld_s:.1f}s on the host), ε after one "
          f"round {cert:.4f} (rdp {eps[0]:.4f}) [{card}]", flush=True)
    del engine
    torch.cuda.empty_cache()

    # adaptive clipping, run_round only
    engine = central_dp_engine(adaptive_clipping=True)
    require(abs(engine._clip_count_stddev - CDP_RATE * NUM_CLIENTS / 20)
            < 1e-12, f"σ_b {engine._clip_count_stddev}")
    try:
        engine.run_rounds_pipelined(1)
        require(False, "run_rounds_pipelined took adaptive clipping")
    except ValueError:
        pass
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = [engine.run_round(evaluate=False) for _ in range(CDP_ROUNDS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_cdp_launches("adaptive", ops.launch_counts(), CDP_ROUNDS)
    clips = [r.clip_norm for r in results] + [engine.clip_norm]
    check_cdp_rounds("adaptive", engine, results, clips)
    cfg = engine.config
    fracs = [cfg.clip_quantile - math.log(b / a) / cfg.clip_lr
             for a, b in zip(clips, clips[1:])]
    require(all(math.isfinite(c) and c > 0 for c in clips)
            and all(-1.0 < f < 2.0 for f in fracs),
            f"adaptive: clip norms {clips}, fractions {fracs}")
    print(f"central_dp adaptive: σ_b={engine._clip_count_stddev} "
          f"z_Δ={engine._z_delta:.5f}, {CDP_ROUNDS} run_round rounds in "
          f"{dt:.3f}s, clip norm by round {[round(c, 5) for c in clips]}, "
          f"noisy clipped fraction by round {[round(f, 4) for f in fracs]};"
          f" run_rounds_pipelined refused [{card}]", flush=True)
    del engine, results
    torch.cuda.empty_cache()

    # the update-canary membership audit at full width
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = run_client_membership_audit(
        bench_model(), bench_arrays(), central_dp_config(),
        num_canaries=AUDIT_CANARIES, num_rounds=AUDIT_ROUNDS, seed=0)
    dt = time.perf_counter() - t0
    check_cdp_launches("audit", ops.launch_counts(), AUDIT_ROUNDS)
    require(np.isfinite(out["scores"]).all() and out["consistent"]
            and out["empirical_epsilon_lower_bound"]
            <= out["certified_epsilon"],
            f"audit: lower bound {out['empirical_epsilon_lower_bound']} "
            f"against certified {out['certified_epsilon']}")
    print(f"central_dp audit: {AUDIT_CANARIES} update canaries "
          f"({NUM_CLIENTS + AUDIT_CANARIES} clients), {AUDIT_ROUNDS} rounds "
          f"in {dt:.1f}s, {out['num_correct']}/{out['num_guesses']} "
          f"guesses right, ε lower bound "
          f"{out['empirical_epsilon_lower_bound']:.4f} <= certified "
          f"{out['certified_epsilon']:.4f} [{card}]", flush=True)
    torch.cuda.empty_cache()

    check_cdp_functions(card)
    return counts


def variant_engine(name, **overrides):
    """The 512-client bf16 engine of cell ``name`` (V1..V4) of the slice's
    local-training and server-side rounds; V1 with its epoch budgets.
    ``overrides`` replace fields of the cell's FederatedTrainingConfig."""
    import dataclasses

    import numpy as np

    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    base = dict(local_epochs=LOCAL_EPOCHS, batch_size=BATCH_SIZE)
    bench_dp = dict(dp_mode="delta", epsilon_per_round=EPS_R,
                    delta_per_round=DELTA_R,
                    privacy=PrivacyConfig(epsilon=1.0, delta=1e-5,
                                          max_grad_norm=1.0))
    if name == "V1":
        training = FederatedTrainingConfig(
            **base, learning_rate=0.001, optimizer_type="sgd", momentum=0.9)
        cfg = dict(fednova=True, dp_mode="delta", epsilon_per_round=V1_EPS_R,
                   delta_per_round=V1_DELTA_R,
                   privacy=PrivacyConfig(epsilon=28 * V1_EPS_R, delta=1e-5,
                                         max_grad_norm=1.0))
    elif name == "V2":
        training = FederatedTrainingConfig(
            **base, learning_rate=0.001, optimizer_type="adamw",
            weight_decay=1e-4, proximal_mu=0.01,
            param_storage_dtype="bfloat16",
            optimizer_state_dtype="bfloat16")
        cfg = dict(aggregation="median", **bench_dp)
    elif name == "V3":
        training = FederatedTrainingConfig(
            **base, learning_rate=0.05, optimizer_type="sgd", momentum=0.0)
        cfg = dict(scaffold=True)
    else:
        training = bench_training()
        cfg = dict(server_optimizer="fedadam", server_lr=0.01,
                   secure_aggregation=True, **bench_dp)
    engine = FederatedRoundEngine(
        bench_model(), bench_arrays(),
        RoundEngineConfig(training=dataclasses.replace(training, **overrides),
                          max_clients=NUM_CLIENTS,
                          seed=0, **cfg), device=DEVICE)
    if name == "V1":
        engine.epochs_per_client = 1 + np.arange(NUM_CLIENTS) % LOCAL_EPOCHS
    return engine


VARIANT_LABELS = {
    "V1": "sgd momentum 0.9 + fednova, epochs 1 + (i mod 5) of 5, delta DP "
          f"at eps_r={V1_EPS_R}",
    "V2": "adamw wd 1e-4 + fedprox mu 0.01 + bf16 param storage + median, "
          "delta DP at the bench's eps_r=1/28",
    "V3": "scaffold, sgd lr 0.05 momentum 0, no DP",
    "V4": "fedadam server_lr 0.01 + secure aggregation, delta DP at the "
          "bench's eps_r=1/28",
}


def run_variant(card, name):
    """One warm-up and VARIANT_ROUNDS pipelined rounds of cell ``name``:
    K1/K2 10 times a round on the tensor cores (the masked epochs of V1
    included), K3 twice a round under delta DP, nothing else; finite
    losses and parameters. Returns the engine."""
    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.ops import conv_block as cb

    engine = variant_engine(name)
    t0 = time.perf_counter()
    warm = engine.run_round(evaluate=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    c_norms = []
    if engine.config.scaffold:   # |c| after each round, kept on the device
        dispatch = engine._dispatch_round

        def dispatch_and_note_c(*args, **kwargs):
            pending = dispatch(*args, **kwargs)
            c_norms.append(torch.linalg.vector_norm(engine.scaffold_c))
            return pending

        c_norms.append(torch.linalg.vector_norm(engine.scaffold_c))
        engine._dispatch_round = dispatch_and_note_c
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run_rounds_pipelined(VARIANT_ROUNDS, evaluate=False)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    engine.__dict__.pop("_dispatch_round", None)

    steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
    dp = engine.config.dp_mode == "delta"
    want = dict.fromkeys(counts, 0)
    want.update(conv_block_fwd=steps * VARIANT_ROUNDS,
                conv_block_bwd=steps * VARIANT_ROUNDS,
                clip_noise=2 * VARIANT_ROUNDS if dp else 0)
    require(counts == want, f"{name}: launch counts {counts}, expected "
                            f"{want}")
    require(all(cb.ROUTE_LAUNCHES[(k, "tensor_core")] == want[k]
                for k in ("conv_block_fwd", "conv_block_bwd")),
            f"{name}: launches by route "
            f"{ {k: v for k, v in cb.ROUTE_LAUNCHES.items() if v} }")
    losses = [warm.train_loss] + [r.train_loss for r in results]
    require(len(results) == VARIANT_ROUNDS
            and all(math.isfinite(v) for v in losses),
            f"{name}: losses {losses}")
    params = engine.global_variables["params"]
    require(all(bool(torch.isfinite(t).all())
                for d in params.values() for t in d.values()),
            f"{name}: non-finite global parameters")
    require(np.isfinite(engine.last_client_losses).all(),
            f"{name}: non-finite client losses")
    extra = ""
    if engine.config.scaffold:
        norms = [float(v) for v in c_norms]
        require(len(norms) == VARIANT_ROUNDS + 1
                and all(math.isfinite(v) and v > 0 for v in norms),
                f"{name}: |c| by round {norms}")
        extra = f", |c| by round {[round(v, 5) for v in norms]}"
    if engine.server_opt_state is not None:
        require(engine.server_opt_state["count"] == VARIANT_ROUNDS + 1,
                f"{name}: server steps {engine.server_opt_state['count']}")
        extra = f", server steps {engine.server_opt_state['count']}"
    per_round = {k: v // VARIANT_ROUNDS for k, v in counts.items() if v}
    print(f"fl_variants {name} ({VARIANT_LABELS[name]}): {NUM_CLIENTS} "
          f"clients bf16, warm-up round {warm_s:.2f}s, {VARIANT_ROUNDS} "
          f"pipelined rounds in {dt:.3f}s -> {VARIANT_ROUNDS / dt:.3f} "
          f"rounds/s, peak memory {peak:.2f} GiB, losses "
          f"{[round(v, 4) for v in losses]}{extra}, launches a round "
          f"{per_round} (0 elsewhere) [{card}]", flush=True)
    return engine


def round_delta_matrix(engine):
    """One round's (C, D_pad) f32 matrix of the clients' local-training
    deltas against the global model (before any DP), and its spec."""
    from fl_tpu_torch.core import prng
    from fl_tpu_torch.core.pytree import tree_map
    from fl_tpu_torch.ops.flatten import stack_flatten

    g = engine.global_variables["params"]
    C = engine.num_clients
    new, _ = engine._local_train(
        tree_map(lambda t: t[None].expand(C, *t.shape), g),
        engine.data.images, engine.data.labels, engine.data.num_samples,
        prng.round_seed(engine._root, engine.round_number))
    return stack_flatten(tree_map(lambda c, t: (c - t[None]).float(), new,
                                  g))


def check_aggregators(card, engine):
    """The server-side functions on one round's (512, 421,760) delta
    matrix: trimmed mean (k = TRIM_K), median and multi-Krum (f = KRUM_F,
    m in KRUM_M) over 90% of the clients, timed and held to f64 on the
    host (AGG_COLUMNS sampled columns; Krum's whole selection); the secure
    sum against the plain weighted sum at full width; the stochastic bf16
    rounding by its bias over ROUNDING_SEEDS seeds on fc1's kernel, and on
    the card equal to the CPU bit for bit on 8 clients' rows."""
    import numpy as np
    import torch

    from fl_tpu_torch.core import prng
    from fl_tpu_torch.fl import robust_agg as ra
    from fl_tpu_torch.fl.fedavg import fedavg_delta, normalized_client_weights
    from fl_tpu_torch.fl.secure_agg import secure_fedavg_delta
    from fl_tpu_torch.ops import rounding
    from fl_tpu_torch.ops.flatten import stack_unflatten

    mat, spec = round_delta_matrix(engine)
    C, D = mat.shape[0], spec[2]
    rng = np.random.default_rng(5)
    mask_np = (rng.random(C) >= AGG_DROP).astype(np.float32)
    mask = torch.as_tensor(mask_np, device=DEVICE)
    m = int(mask_np.sum())
    cols = np.sort(rng.choice(D, AGG_COLUMNS, replace=False))
    sub = mat[:, torch.as_tensor(cols, device=DEVICE)].double().cpu().numpy()
    alive = np.flatnonzero(mask_np > 0)
    srt = np.sort(sub[alive], axis=0)
    ref = {"trimmed_mean": srt[TRIM_K:m - TRIM_K].mean(0),
           "median": np.median(sub[alive], axis=0)}
    funcs = {"trimmed_mean": lambda: ra.trimmed_mean_matrix(mat, mask,
                                                           TRIM_K),
             "median": lambda: ra.median_matrix(mat, mask)}
    parts = []
    for key, fn in funcs.items():
        got = fn()[torch.as_tensor(cols, device=DEVICE)].double().cpu()
        err = float(np.abs(got.numpy() - ref[key]).max()
                    / np.abs(ref[key]).max())
        require(err <= AGG_TOL, f"{key}: {err:.2e} of the largest value "
                                "from f64")
        parts.append(f"{key} {time_ms(fn):.2f} ms (err {err:.1e})")

    # Krum against f64 scores of the whole matrix on the host
    full = mat[:, :D].double().cpu()
    sq = (full * full).sum(1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (full @ full.T)).clamp(min=0)
    del full
    d2 = d2.numpy()
    for mk in KRUM_M:
        picked = ra.krum_select(mat, mask, KRUM_F, mk).cpu().numpy()
        k_near = max(m - KRUM_F - 2, 1)
        sub_d2 = d2[np.ix_(alive, alive)]
        np.fill_diagonal(sub_d2, np.inf)
        scores = dict(zip(alive, np.sort(sub_d2, 1)[:, :k_near].sum(1)))
        best = sorted(alive, key=lambda i: (scores[i], i))[:mk]
        worst_in = max(scores[i] for i in picked)
        best_out = min(scores[i] for i in alive if i not in set(picked))
        require(len(set(picked)) == mk and set(picked) <= set(alive)
                and worst_in <= best_out * (1 + KRUM_SCORE_TOL),
                f"krum m={mk}: picked {sorted(picked)}, f64 picks "
                f"{sorted(best)}")
        avg = ra.krum_matrix(mat, mask, KRUM_F, mk)
        want = mat[torch.as_tensor(sorted(best), device=DEVICE)].double(
            ).mean(0)
        err = float((avg.double() - want).abs().max() / want.abs().max())
        same = sorted(picked) == sorted(best)
        require(err <= AGG_TOL or not same, f"krum m={mk}: {err:.2e}")
        ms = time_ms(lambda: ra.krum_matrix(mat, mask, KRUM_F, mk))
        how = "equal to" if same else "within the score tolerance of"
        parts.append(f"krum f={KRUM_F} m={mk} {ms:.2f} ms (picks {how} "
                     f"f64's, err {err:.1e})")
    # the Gram product stays off TF32 whatever the global switch says
    torch.backends.cuda.matmul.allow_tf32 = True
    d2_tf32_on = ra.pairwise_sq_distances(mat)
    torch.backends.cuda.matmul.allow_tf32 = False
    require(torch.equal(d2_tf32_on, ra.pairwise_sq_distances(mat)),
            "krum's Gram product changed with the TF32 switch")

    # the secure sum against the plain weighted sum, at full width
    g = engine.global_variables["params"]
    deltas = stack_unflatten(mat, spec)
    stacked = {l: {k: g[l][k][None] + deltas[l][k] for k in g[l]} for l in g}
    del deltas
    n = engine.data.num_samples
    w = normalized_client_weights(n, mask)
    rseed = prng.round_seed(engine._root, engine.round_number)
    plain = fedavg_delta(g, stacked, w)
    secure = secure_fedavg_delta(g, stacked, n, mask, rseed)
    worst = max(float(((secure[l][k] - plain[l][k]).abs()
                       - 1e-4 * plain[l][k].abs()).max()) for l in g
                for k in g[l])
    require(worst <= 1e-5, f"secure sum off the plain sum by {worst:.2e}")
    plain_ms = time_ms(lambda: fedavg_delta(g, stacked, w))
    secure_ms = time_ms(lambda: secure_fedavg_delta(g, stacked, n, mask,
                                                    rseed))
    parts.append(f"secure sum {secure_ms:.2f} ms vs plain weighted sum "
                 f"{plain_ms:.2f} ms (within rtol 1e-4 / atol 1e-5)")
    del stacked, plain, secure

    # stochastic rounding: unbiased over seeds; the card equals the CPU
    x = g["fc1"]["kernel"].float().reshape(-1)
    acc = torch.zeros_like(x, dtype=torch.float64)
    # the spacing of bf16 in x's binade [2^(e-1), 2^e): 2^(e-8)
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
    for seed in range(ROUNDING_SEEDS):
        r = rounding.stochastic_round_bf16(x, seed).float()
        require(bool(((r - x).abs() <= ulp * 1.0001).all()),
                "stochastic rounding left the two bf16 neighbours")
        acc += r.double()
    bias = ((acc / ROUNDING_SEEDS - x.double()) / ulp.double())
    mean_bias, mean_abs = float(bias.mean()), float(bias.abs().mean())
    require(abs(mean_bias) < 5e-3 and mean_abs < 0.1,
            f"rounding bias {mean_bias:.2e} ulp, mean |bias| {mean_abs:.3f}")
    rows = mat[COMPRESSION_ROWS]
    seeds = torch.arange(rows.shape[0], device=DEVICE) * 2654435761 % 2 ** 32
    on_card = rounding.stochastic_round_bf16(rows, seeds)
    on_cpu = rounding.stochastic_round_bf16(rows.cpu(), seeds.cpu())
    require(torch.equal(on_card.cpu().view(torch.int16),
                        on_cpu.view(torch.int16)),
            "stochastic rounding on the card differs from the CPU")
    leaf = mat[:, :x.numel()].contiguous()
    sr_ms = time_ms(lambda: rounding.stochastic_round_bf16(
        leaf, torch.arange(C, device=DEVICE)))
    parts.append(f"stochastic_round_bf16 bias over {ROUNDING_SEEDS} seeds "
                 f"{mean_bias:.1e} ulp (mean |bias| {mean_abs:.3f} ulp), "
                 f"card = CPU bit for bit on 8 clients' rows, "
                 f"{sr_ms:.2f} ms on the stacked fc1 kernel "
                 f"({C} x {x.numel()})")
    print(f"fl_variants functions on one round's ({C}, {mat.shape[1]}) "
          f"delta matrix, {m} participants: " + "; ".join(parts)
          + f" [{card}]", flush=True)


def phase_fl_variants(card):
    """The slice's local-training options and first server-side features
    on the 512-client bf16 round (V1..V4), then the aggregator and
    rounding functions on one round's delta matrix."""
    import torch

    for name in VARIANTS:
        engine = run_variant(card, name)
        if name == "V3":
            check_aggregators(card, engine)
        del engine
        torch.cuda.empty_cache()


def api_engine(name, num_clients=NUM_CLIENTS):
    """The 512-client bf16 engine of cell ``name`` of the server side's
    second half: V5 FedDyn (α = 0.01) and V6 q-FFL (q = 1) with the bench's
    Adam and no DP, V7 PEFT (``.*conv.*`` trainable) under the bench's
    delta DP, V8 the bench round itself."""
    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    if name == "V8":
        return make_bench_engine("residual")
    cfg = {"V5": dict(feddyn_alpha=FEDDYN_ALPHA),
           "V6": dict(qffl_q=QFFL_Q),
           "V7": dict(trainable_patterns=PEFT_PATTERNS, dp_mode="delta",
                      privacy=PrivacyConfig(epsilon=1.0, delta=1e-5,
                                            max_grad_norm=1.0),
                      epsilon_per_round=EPS_R,
                      delta_per_round=DELTA_R)}[name]
    return FederatedRoundEngine(
        bench_model(), bench_arrays(),
        RoundEngineConfig(training=bench_training(), max_clients=NUM_CLIENTS,
                          seed=0, **cfg), device=DEVICE)


API_LABELS = {
    "V5": f"feddyn alpha={FEDDYN_ALPHA}, adam, no DP",
    "V6": f"q-ffl q={QFFL_Q}, adam, no DP",
    "V7": "peft conv layers trainable, delta DP at the bench's eps_r=1/28",
    "V8": "the bench round (delta DP) through run_rounds_fused",
}


def check_finite_params(label, engine):
    import torch

    params = engine.global_variables["params"]
    require(all(bool(torch.isfinite(t).all())
                for d in params.values() for t in d.values()),
            f"{label}: non-finite global parameters")


def run_api_cell(card, name, counts):
    """One warm-up and API_ROUNDS pipelined rounds of cell ``name``, the
    counts set to 0 just before the pipelined rounds and read just after
    (added to ``counts``): K1/K2 10 times a round on the tensor cores, K1
    once more under q-FFL (F_k(θ̂), one chunk of 64 images a client), K3
    twice under delta DP. V5's pipelined rounds leave every 8th client out:
    h and g finite, the absent clients' g_i unchanged bit for bit, every
    other g_i moved. V6's pre-losses finite. Returns the engine."""
    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.ops import conv_block as cb

    engine = api_engine(name)
    t0 = time.perf_counter()
    warm = engine.run_round(evaluate=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    masks = None
    if name == "V5":
        masks = np.ones((API_ROUNDS, NUM_CLIENTS), np.float32)
        masks[:, FEDDYN_OUT] = 0.0
        g_before = engine.feddyn_grads.cpu()   # off the card's peak
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run_rounds_pipelined(API_ROUNDS, evaluate=False,
                                          masks=masks)
    dt = time.perf_counter() - t0
    got = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
    qffl = engine.config.qffl_q is not None
    dp = engine.config.dp_mode == "delta"
    want = dict.fromkeys(got, 0)
    want.update(conv_block_fwd=(steps + qffl) * API_ROUNDS,
                conv_block_bwd=steps * API_ROUNDS,
                clip_noise=2 * API_ROUNDS if dp else 0)
    require(got == want, f"{name}: launch counts {got}, expected {want}")
    require(all(cb.ROUTE_LAUNCHES[(k, "tensor_core")] == want[k]
                for k in ("conv_block_fwd", "conv_block_bwd")),
            f"{name}: launches by route "
            f"{ {k: v for k, v in cb.ROUTE_LAUNCHES.items() if v} }")
    for k in ("conv_block_fwd", "conv_block_bwd", "clip_noise"):
        counts[k] = counts.get(k, 0) + got[k]
    losses = [warm.train_loss] + [r.train_loss for r in results]
    require(all(math.isfinite(v) for v in losses), f"{name}: losses {losses}")
    check_finite_params(name, engine)
    extra = ""
    if name == "V5":
        h, g = engine.feddyn_h, engine.feddyn_grads
        require(bool(torch.isfinite(h).all() and torch.isfinite(g).all()),
                "V5: non-finite FedDyn state")
        out = torch.zeros(NUM_CLIENTS, dtype=torch.bool)
        out[FEDDYN_OUT] = True
        same = (g.cpu() == g_before).all(1)
        require(bool(same[out].all()) and not bool(same[~out].any()),
                f"V5: g_i changed for {int((~same[out]).sum())} absent "
                f"clients, kept for {int(same[~out].sum())} participants")
        extra = (f", |h| {float(torch.linalg.vector_norm(h)):.5f}, "
                 f"|g| {float(torch.linalg.vector_norm(g)):.4f}, g_i of the "
                 f"{int(out.sum())} absent clients unchanged")
        del g_before
    if qffl:
        pre = engine.last_client_pre_losses
        require(pre.shape == (NUM_CLIENTS,) and np.isfinite(pre).all(),
                "V6: non-finite pre-losses")
        extra = (f", F_k(theta^) mean {pre.mean():.4f} min {pre.min():.4f}"
                 f" max {pre.max():.4f}")
    per_round = {k: v // API_ROUNDS for k, v in got.items() if v}
    print(f"engine_api {name} ({API_LABELS[name]}): {NUM_CLIENTS} clients "
          f"bf16, warm-up round {warm_s:.2f}s, {API_ROUNDS} pipelined rounds "
          f"in {dt:.3f}s -> {API_ROUNDS / dt:.3f} rounds/s, peak memory "
          f"{peak:.2f} GiB, losses {[round(v, 4) for v in losses]}{extra}, "
          f"launches a round {per_round} (0 elsewhere) [{card}]", flush=True)
    return engine


def peft_frozen_check(card):
    """10 clients, 2 rounds, no DP: fc1 and fc2 keep their initial bits."""
    import torch

    from fl_tpu_torch.data import load_dataset, make_federated_arrays
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    splits = load_dataset("mnist", n_train_synth=1024, n_test_synth=64)
    engine = FederatedRoundEngine(
        bench_model(), make_federated_arrays(splits, 10, "iid", seed=0),
        RoundEngineConfig(training=bench_training(),
                          trainable_patterns=PEFT_PATTERNS, seed=0),
        device=DEVICE)
    init = {l: {k: v.clone() for k, v in d.items()}
            for l, d in engine.global_variables["params"].items()}
    engine.run_rounds_pipelined(2)
    p = engine.global_variables["params"]
    frozen = all(torch.equal(p[l][k], init[l][k]) for l in ("fc1", "fc2")
                 for k in p[l])
    moved = not torch.equal(p["conv2"]["kernel"], init["conv2"]["kernel"])
    require(frozen and moved, f"V7: fc1/fc2 bit-equal {frozen}, conv2 "
                              f"moved {moved}")
    print(f"engine_api V7 frozen: 10 clients, 2 rounds, no DP: fc1 and fc2 "
          f"equal their initial values bit for bit, conv1/conv2 trained "
          f"[{card}]", flush=True)


def count_syncs(fn):
    """``fn()`` with torch's synchronizing-call warnings on: its result and
    the (file:line) of every synchronizing CUDA call it made."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
             for w in caught if "synchroniz" in str(w.message)]
    return out, sites


def fused_runner(card, counts):
    """V8: the bench round, FUSED_ROUNDS rounds through run_rounds_fused
    against run_rounds_pipelined on two engines in the same call, after a
    warm-up round each: the host syncs of each runner counted (the fused
    one must make one, its device→host copy of the stacked metrics), both
    rates, K1/K2/K3's launches of the fused rounds (added to ``counts``)."""
    import torch

    from fl_tpu_torch import ops

    rates, syncs = {}, {}
    for runner in ("fused", "pipelined"):
        engine = api_engine("V8")
        engine.run_round(evaluate=False)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if runner == "fused":
            results, sites = count_syncs(lambda: engine.run_rounds_fused(
                FUSED_ROUNDS, evaluate=False))
        else:
            results, sites = count_syncs(lambda: engine.run_rounds_pipelined(
                FUSED_ROUNDS, evaluate=False))
        dt = time.perf_counter() - t0
        got = ops.launch_counts()
        steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
        want = dict.fromkeys(got, 0)
        want.update(conv_block_fwd=steps * FUSED_ROUNDS,
                    conv_block_bwd=steps * FUSED_ROUNDS,
                    clip_noise=2 * FUSED_ROUNDS)
        require(got == want, f"V8 {runner}: launch counts {got}, expected "
                             f"{want}")
        require(len(results) == FUSED_ROUNDS
                and all(math.isfinite(r.train_loss) for r in results),
                f"V8 {runner}: losses {[r.train_loss for r in results]}")
        check_finite_params(f"V8 {runner}", engine)
        spent = engine.budget_tracker.consumed_epsilon
        require(math.isclose(spent, (FUSED_ROUNDS + 1) * EPS_R,
                             rel_tol=1e-12),
                f"V8 {runner}: eps spent {spent}")
        if runner == "fused":
            for k in ("conv_block_fwd", "conv_block_bwd", "clip_noise"):
                counts[k] = counts.get(k, 0) + got[k]
        rates[runner], syncs[runner] = FUSED_ROUNDS / dt, sites
        del engine
        torch.cuda.empty_cache()
    require(len(syncs["fused"]) == 1,
            f"V8: run_rounds_fused made {len(syncs['fused'])} host syncs, "
            f"at {syncs['fused']}")
    print(f"engine_api V8 ({API_LABELS['V8']}): {NUM_CLIENTS} clients bf16, "
          f"{FUSED_ROUNDS} rounds: fused {rates['fused']:.3f} rounds/s with "
          f"{len(syncs['fused'])} host sync ({', '.join(syncs['fused'])}), "
          f"pipelined {rates['pipelined']:.3f} rounds/s with "
          f"{len(syncs['pipelined'])} host syncs; launches a round "
          f"conv_block_fwd/bwd {LOCAL_EPOCHS * SAMPLES_PER_CLIENT // BATCH_SIZE}"
          f", clip_noise 2 [{card}]", flush=True)


def entry_points_on(card, engine):
    """On V5's engine: federated and personalized evaluation at 512
    clients (timed, K1 launched), a checkpoint saved and restored into a
    fresh engine whose next round must equal the uninterrupted engine's
    bit for bit, and one profiled round's Chrome trace."""
    import tempfile

    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.orchestration.checkpoint import (
        restore_engine_checkpoint, save_engine_checkpoint)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fed = engine.evaluate_federated()
    fed_s = time.perf_counter() - t0
    fed_launch = ops.launch_counts()["conv_block_fwd"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pers = engine.evaluate_personalized()
    pers_s = time.perf_counter() - t0
    pers_launch = ops.launch_counts()
    require(fed_launch == 1 and np.isfinite(fed["per_client"]["loss"]).all(),
            f"evaluate_federated: K1 launches {fed_launch}, losses finite "
            f"{np.isfinite(fed['per_client']['loss']).all()}")
    require(pers_launch["conv_block_fwd"] > 0
            and np.isfinite(pers["per_client"]["personalized_loss"]).all(),
            f"evaluate_personalized: launches {pers_launch}")
    print(f"engine_api V5 evaluate_federated: {NUM_CLIENTS} clients in "
          f"{fed_s:.3f}s (K1 x{fed_launch}), accuracy "
          f"{fed['accuracy']:.4f} (min {fed['accuracy_min']:.4f}, max "
          f"{fed['accuracy_max']:.4f}, std {fed['accuracy_std']:.4f}); "
          f"evaluate_personalized: {pers_s:.3f}s (K1 x"
          f"{pers_launch['conv_block_fwd']}, K2 x"
          f"{pers_launch['conv_block_bwd']}), global "
          f"{pers['mean_global_accuracy']:.4f} -> personalized "
          f"{pers['mean_personalized_accuracy']:.4f} [{card}]", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_engine_checkpoint(engine, tmp)
        save_s = time.perf_counter() - t0
        fresh = api_engine("V5")
        t0 = time.perf_counter()
        step = restore_engine_checkpoint(fresh, tmp)
        restore_s = time.perf_counter() - t0
        engine.run_round(evaluate=False)
        fresh.run_round(evaluate=False)
        a, b = engine.global_variables["params"], fresh.global_variables[
            "params"]
        same = (all(torch.equal(a[l][k], b[l][k]) for l in a for k in a[l])
                and torch.equal(engine.feddyn_h, fresh.feddyn_h)
                and torch.equal(engine.feddyn_grads, fresh.feddyn_grads))
        require(same, "V5: the restored engine's next round differs from "
                      "the uninterrupted engine's")
        del fresh
        torch.cuda.empty_cache()
        result = engine.profile_round(os.path.join(tmp, "trace"))
        trace = engine.last_trace_path
        require(os.path.isfile(trace) and os.path.getsize(trace) > 0,
                f"profile_round wrote no trace ({trace})")
        trace_mb = os.path.getsize(trace) / 2 ** 20
    print(f"engine_api V5 checkpoint: saved in {save_s:.2f}s, restored at "
          f"round {step} in {restore_s:.2f}s into a fresh engine, its next "
          f"round equal to the uninterrupted engine's bit for bit (params, "
          f"h, g); profile_round: round {result.round_number}, "
          f"{trace_mb:.1f} MiB Chrome trace [{card}]", flush=True)


def check_eval_forward(card, report):
    """K1 as the evaluation paths launch it (V6's F_k(θ̂), federated
    evaluation, personalization's holdout): ``conv_stack_res`` under
    ``torch.no_grad`` on a whole 64-image shard for each of the 512
    clients in bf16, one launch and nothing else, held to the plain
    version within one bf16 ulp (check_pooled). Its error joins K1's
    ``max_abs_err``."""
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.ops import conv_block as cb

    gen = torch.Generator(device="cuda").manual_seed(12)
    args = conv_inputs(gen, NUM_CLIENTS, SAMPLES_PER_CLIENT, torch.bfloat16)
    ops.reset_launch_counts()
    with torch.no_grad():
        pooled = cb.conv_stack_res(*args)
    torch.cuda.synchronize()
    got = {k: v for k, v in ops.launch_counts().items() if v}
    require(got == {"conv_block_fwd": 1} and not pooled.requires_grad,
            f"K1 under no_grad: launches {got}")
    p_ref, _ = cb.conv_stack_res_plain(*args)
    tag = f"eval bf16 C={NUM_CLIENTS} B={SAMPLES_PER_CLIENT} no_grad"
    err = check_pooled("K1", tag, pooled, p_ref, torch.bfloat16)
    entry = report["conv_block_fwd"]
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    print(f"engine_api K1 forward-only ({tag}): one launch, max abs error "
          f"{err:.3e} against the plain version (tol 1 bf16 ulp) [{card}]",
          flush=True)
    del args, pooled, p_ref
    torch.cuda.empty_cache()


def phase_engine_api(card, counts, report):
    """The server side's second half and the engine's other entry points
    on the 512-client bf16 round: K1 at the evaluation paths' shape
    against its plain version; V5 FedDyn and, on its engine, the
    evaluations, checkpoint and resume, and the profiler; V6 q-FFL; V7
    PEFT and its 10-client frozen-leaf check; V8 the fused runner. One
    512-client engine is resident at a time."""
    import torch

    check_eval_forward(card, report)
    for name in API_CELLS:
        engine = run_api_cell(card, name, counts)
        if name == "V5":
            entry_points_on(card, engine)
        del engine
        torch.cuda.empty_cache()
    peft_frozen_check(card)
    fused_runner(card, counts)


def mechanism_cells():
    """The other DP mechanisms' bench cells: name -> mechanism_engine's
    keywords (``tools/profile_round.py`` profiles the same cells)."""
    dpsgd = dict(epsilon=DPSGD_EPSILON, z=DPSGD_Z, clip=DPSGD_CLIP,
                 dp_mode="dp_sgd", dp_microbatch=DPSGD_MICRO)
    dist = dict(epsilon=DIST_EPSILON, z=DIST_Z, clip=DIST_CLIP,
                dp_mode="distributed", participation_rate=CDP_RATE)
    return {
        "dp-sgd-microbatch": dict(dpsgd, fused="residual",
                                  dp_sgd_impl="microbatch"),
        "dp-sgd-ghost": dict(dpsgd, fused=False, dp_sgd_impl="ghost"),
        "dp-ftrl": dict(epsilon=FTRL_EPSILON, z=FTRL_Z, dp_mode="dp_ftrl",
                        ftrl_rounds=FTRL_T, participation_rate=CDP_RATE),
        "distributed-fused": dict(dist, dist_fuse_noise=True),
        "distributed-per-client": dict(dist, dist_fuse_noise=False),
    }


def mechanism_engine(fused="residual", epsilon=64.0, z=1.0, clip=1.0,
                     **cfg):
    """The 512-client bf16 bench engine under one of the other DP
    mechanisms (``cfg`` holds dp_mode and its fields)."""
    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    return FederatedRoundEngine(
        bench_model(fused), bench_arrays(),
        RoundEngineConfig(training=bench_training(),
                          privacy=PrivacyConfig(
                              epsilon=epsilon, delta=MECH_DELTA,
                              max_grad_norm=clip, noise_multiplier=z),
                          max_clients=NUM_CLIENTS, seed=0, **cfg),
        device=DEVICE)


def run_mechanism_cell(card, label, engine, per_round, rounds=MECH_ROUNDS):
    """A warm-up round, then ``rounds`` pipelined ones whose launches must
    be ``per_round`` a round (the conv ones on the tensor cores) and 0
    elsewhere; finite losses and parameters. Prints rounds/s and peak
    memory; returns (the round results with the warm-up first, counts,
    the line's text so far)."""
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.ops import conv_block as cb

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = engine.run_round(evaluate=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run_rounds_pipelined(rounds, evaluate=False)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = dict.fromkeys(counts, 0)
    want.update({k: v * rounds for k, v in per_round.items()})
    require(counts == want, f"{label}: launch counts {counts}, expected "
                            f"{want}")
    require(all(cb.ROUTE_LAUNCHES[(k, "tensor_core")] == want[k]
                for k in ("conv_block_fwd", "conv_block_bwd")),
            f"{label}: launches by route "
            f"{ {k: v for k, v in cb.ROUTE_LAUNCHES.items() if v} }")
    results = [warm] + results
    losses = [r.train_loss for r in results]
    params = engine.global_variables["params"]
    require(all(math.isfinite(v) for v in losses)
            and all(bool(torch.isfinite(t).all())
                    for d in params.values() for t in d.values()),
            f"{label}: losses {losses} or the parameters not finite")
    used = {k: v // rounds for k, v in counts.items() if v}
    text = (f"{label}: {NUM_CLIENTS} clients bf16, warm-up round "
            f"{warm_s:.2f}s (peak memory over it and the pipelined rounds "
            f"{peak:.2f} GiB), {rounds} pipelined rounds in {dt:.3f}s -> "
            f"{rounds / dt:.3f} rounds/s, launches a round {used} (0 "
            f"elsewhere), losses {[round(v, 4) for v in losses]}")
    return results, counts, text


def check_dp_sgd_epsilon(label, engine, results):
    """ε after each round: the engine's RDP accountant against a fresh one
    stepped at (q = batch/shard, z) 10 times a round, bit for bit."""
    from fl_tpu_torch.fl.accounting import RDPAccountant

    fresh = RDPAccountant()
    q = BATCH_SIZE / SAMPLES_PER_CLIENT
    steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
    eps = []
    for i, entry in enumerate(engine.accountant.get_privacy_ledger()):
        fresh.step(q, DPSGD_Z, steps)
        want = fresh.get_epsilon(MECH_DELTA)
        require(entry["metadata"]["total_epsilon"] == want
                and entry["noise_scale"] == DPSGD_Z * DPSGD_CLIP / BATCH_SIZE,
                f"{label}: round {i} ledger {entry}, ε {want}")
        eps.append(want)
    require(len(eps) == len(results)
            and engine.certified_epsilon() == eps[-1],
            f"{label}: certified {engine.certified_epsilon()}, ε {eps}")
    return eps


def check_fold_kernels(card, report):
    """K1/K2 (and K4) at the microbatch fold's shape, 512 clients x 16
    examples folded into 8192 clients of one image, bf16 and f32, against
    their plain versions (check_conv's tolerances), and timed. The errors
    join K1's and K2's ``max_abs_err``."""
    import torch

    from fl_tpu_torch.ops import conv_block as cb

    gen = torch.Generator(device="cuda").manual_seed(21)
    C = NUM_CLIENTS * DPSGD_MICRO
    parts = []
    for dtype in (torch.bfloat16, torch.float32):
        got = check_conv(cb, gen, C, 1, dtype)
        for k in ("conv_block_fwd", "conv_block_bwd"):
            entry = report[k]
            entry["max_abs_err"] = max(entry["max_abs_err"], got["err"][k])
        x, w1, b1, w2, b2 = got["args"]
        fwd = time_ms(lambda: cb.conv_block_fwd_cuda(*got["args"]))
        bwd = time_ms(lambda: cb.conv_block_bwd_cuda(
            got["g"], got["idx"], x, w1, b1, w2))
        text = (f"{str(dtype)[6:]}: K1 err "
                f"{got['err']['conv_block_fwd']:.2e} {fwd:.3f} ms, K2 err "
                f"{got['err']['conv_block_bwd']:.2e} {bwd:.3f} ms")
        if dtype == torch.bfloat16:
            bounds, _ = conv_work(got["args"], got["g"])
            text += ", bound " + ", ".join(
                f"{k} {bounds[k][0]:.3f} ms ({bounds[k][1]})"
                for k in ("conv_block_fwd", "conv_block_bwd"))
        parts.append(text)
        del got
    torch.cuda.empty_cache()
    print(f"dp_mechanisms fold kernels at (C·m, B) = ({C}, 1): "
          + "; ".join(parts) + f" [{card}]", flush=True)


def check_mechanism_functions(card):
    """On the card: ghost against microbatch at a small size (f32, the
    reference's rtol 2e-4 / atol 2e-5; microbatch also on K1/K2); the
    DP-FTRL tree's node reuse bit for bit; the Skellam draws by mean and
    variance at the bench plan's per-client and aggregate rates; the
    modular sum against the int64 sum mod 2^32."""
    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.core import prng
    from fl_tpu_torch.fl import distributed_dp as ddp
    from fl_tpu_torch.fl import dp_ftrl as ftrl
    from fl_tpu_torch.fl import privacy as dp
    from fl_tpu_torch.models import create_model

    # ghost = microbatch
    C, B = 4, 8
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    xb = torch.randn((C, B, 28, 28, 1), generator=gen, device=DEVICE)
    yb = torch.randint(0, 10, (C, B), generator=gen, device=DEVICE)
    wmask = torch.ones((C, B), device=DEVICE)
    wmask[1, 5] = 0.0
    unfused = create_model("simple_cnn", dropout_rate=0.0)
    init = unfused.init(torch.Generator(device=DEVICE).manual_seed(0),
                        DEVICE)
    params = {l: {k: torch.stack([v * (1 + 0.1 * c) for c in range(C)])
                  for k, v in d.items()} for l, d in init.items()}
    args = (params, xb, yb, wmask, 1, 2)
    ghost = dp.make_ghost_dp_sgd_grad_fn(unfused, 0.7, 1.1)(*args)
    worst = {}
    ops.reset_launch_counts()
    for fused in (False, "residual"):
        model = create_model("simple_cnn", dropout_rate=0.0,
                             fused_conv_block=fused)
        micro = dp.make_dp_sgd_grad_fn(model, 0.7, 1.1, 4)(*args)
        gap = 0.0
        for l in ghost:
            for k in ghost[l]:
                a, b = ghost[l][k], micro[l][k]
                require(torch.allclose(a, b, rtol=2e-4, atol=2e-5),
                        f"ghost vs microbatch ({fused!r}) {l}/{k}: "
                        f"{float((a - b).abs().max())}")
                gap = max(gap, float((a - b).abs().max()))
        worst[repr(fused)] = gap
    folded = ops.launch_counts()
    require(folded["conv_block_fwd"] == folded["conv_block_bwd"] == B // 4,
            f"microbatch on K1/K2: launches {folded}")

    # the tree's node reuse
    seed, dim, sigma = 77, 1 << 16, 0.5

    def node(level, index):
        g = prng.generator(ftrl.node_seed(seed, level, index), DEVICE)
        return sigma * torch.randn((dim,), generator=g, device=DEVICE)

    zero = torch.zeros(dim, device=DEVICE)
    n2 = ftrl.tree_noise_prefix(seed, 2, dim, sigma, 4, DEVICE)
    n3 = ftrl.tree_noise_prefix(seed, 3, dim, sigma, 4, DEVICE)
    n7 = ftrl.tree_noise_prefix(seed, 7, dim, sigma, 4, DEVICE)
    require(torch.equal(n2, zero + node(1, 0))
            and torch.equal(n3, zero + node(0, 2) + node(1, 0))
            and torch.equal(n7, zero + node(0, 6) + node(1, 2)
                            + node(2, 0)),
            "tree noise: a reused node is not the same draw")
    v7 = float(n7.double().var()) / (3 * sigma ** 2)
    require(abs(v7 - 1) < 5 * math.sqrt(2 / dim), f"tree noise t=7: {v7}")

    # Skellam at the bench plan's rates; the modular sum
    plan = ddp.DistributedDPPlan(DIST_CLIP, 14, N_PARAMS, round(
        CDP_RATE * NUM_CLIENTS), DIST_Z)
    n = 1 << 20
    moments = []
    for lam in (plan.mu_local / 2, plan.expected_clients
                * plan.mu_local / 2):
        draw = ddp.aggregate_skellam_noise(5, lam, n, DEVICE).double()
        mean, var = float(draw.mean()), float(draw.var())
        require(abs(mean) < 5 * math.sqrt(2 * lam / n)
                and abs(var / (2 * lam) - 1) < 5 * math.sqrt(2 / n),
                f"Skellam at λ={lam}: mean {mean}, var {var}")
        moments.append((lam, mean, var / (2 * lam)))
    share = ddp.skellam_noise(6, plan.mu_local / 2, (64, 4096),
                              DEVICE).double()
    require(abs(float(share.var()) / plan.mu_local - 1)
            < 5 * math.sqrt(2 / share.numel()), "Skellam shares")
    ints = torch.randint(-2 ** 31, 2 ** 31, (NUM_CLIENTS, 1 << 16),
                         generator=gen, device=DEVICE, dtype=torch.int64)
    got = ddp.modular_sum(ints.to(torch.int32)).cpu().numpy()
    want = ((ints.sum(0).cpu().numpy() + 2 ** 31) % 2 ** 32
            - 2 ** 31).astype(np.int32)
    require(np.array_equal(got, want), "modular sum differs from the int64 "
                                       "sum mod 2^32")
    print(f"dp_mechanisms functions: ghost vs microbatch (f32, {C} clients "
          f"x {B}) largest gap {worst} (tol rtol 2e-4 / atol 2e-5; the "
          f"microbatch fold on K1/K2 x{B // 4}); tree noise: nodes reused "
          f"bit for bit at t = 2, 3, 7, Var(t=7)/(3σ²) {v7:.4f}; Skellam "
          f"(λ, mean, var/2λ) {[(f'{l:.4g}', round(m, 2), round(v, 5)) for l, m, v in moments]}"
          f" over {n} draws; modular sum of ({NUM_CLIENTS}, {1 << 16}) "
          f"random int32 equal to the int64 sum mod 2^32 [{card}]",
          flush=True)
    torch.cuda.empty_cache()


def ftrl_resume_check(card, engine):
    """On the dp_ftrl cell's engine: a checkpoint saved and restored into a
    fresh engine (another nonce, drawn from OS entropy, replaced by the
    checkpoint's) whose next round equals the uninterrupted engine's bit
    for bit: params, the prefix sums, the momentum, the ledger."""
    import tempfile

    import numpy as np
    import torch

    from fl_tpu_torch.orchestration.checkpoint import (
        restore_engine_checkpoint, save_engine_checkpoint)

    with tempfile.TemporaryDirectory() as tmp:
        save_engine_checkpoint(engine, tmp)
        fresh = mechanism_engine(**mechanism_cells()["dp-ftrl"])
        other = fresh._ftrl_nonce != engine._ftrl_nonce
        step = restore_engine_checkpoint(fresh, tmp)
    engine.run_round(evaluate=False)
    fresh.run_round(evaluate=False)
    a, b = engine.global_variables["params"], fresh.global_variables["params"]
    same = (all(torch.equal(a[l][k], b[l][k]) for l in a for k in a[l])
            and all(torch.equal(getattr(engine, k), getattr(fresh, k))
                    for k in ("ftrl_cumsum", "ftrl_prev_noisy",
                              "ftrl_momentum_buf"))
            and np.array_equal(engine.ftrl_participations,
                               fresh.ftrl_participations)
            and fresh._ftrl_nonce == engine._ftrl_nonce)
    require(other and same, f"dp_ftrl resume: fresh nonce {other}, the next "
                            f"round bit-equal {same}")
    print(f"dp_mechanisms dp_ftrl checkpoint: restored at round {step} into "
          f"a fresh engine (its own nonce replaced by the checkpoint's), "
          f"the next round equal to the uninterrupted engine's bit for bit "
          f"(params, prefix, noisy prefix, momentum, ledger "
          f"{engine.ftrl_participations.sum()} participations) [{card}]",
          flush=True)
    del fresh
    torch.cuda.empty_cache()


def phase_dp_mechanisms(card, report):
    """DP-SGD (microbatch fold on K1/K2, ghost norms on the unfused chain),
    DP-FTRL and distributed DP (fused and per-client Skellam noise) on the
    512-client bench round, each with rounds/s, peak memory and ε after
    the rounds beside the accountant's value; then the fold's kernels,
    the mechanisms' functions and the dp_ftrl resume on the card, and the
    PLD step budget under dp_sgd. Learning checks run with the others."""
    import numpy as np
    import torch

    from fl_tpu_torch.fl import dp_ftrl as ftrl
    from fl_tpu_torch.fl.accounting import RDPAccountant

    steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
    chunks = BATCH_SIZE // DPSGD_MICRO
    cells = mechanism_cells()
    check_fold_kernels(card, report)

    # DP-SGD: the microbatch fold on "residual" (K1 once a step for the
    # metrics' forward and once a chunk, K2 once a chunk), ghost on False;
    # both draw a step's noise through K3, once a leaf (keyed by client)
    noise = dict(clip_noise=steps * SIMPLE_CNN_LEAVES)
    for name, per_round in (
            ("dp-sgd-microbatch", dict(noise,
                                       conv_block_fwd=steps * (1 + chunks),
                                       conv_block_bwd=steps * chunks)),
            ("dp-sgd-ghost", noise)):
        cell = cells[name]
        impl, fused = cell["dp_sgd_impl"], cell["fused"]
        label = f"dp_mechanisms dp_sgd {impl} fused_conv_block={fused!r}"
        engine = mechanism_engine(**cell)
        results, _, text = run_mechanism_cell(card, label, engine, per_round)
        eps = check_dp_sgd_epsilon(label, engine, results)
        fold = (f", fold (C·m, 1) = ({NUM_CLIENTS * DPSGD_MICRO}, 1), "
                f"{chunks} chunks a step" if impl == "microbatch" else "")
        print(f"{text}; q={BATCH_SIZE / SAMPLES_PER_CLIENT} z={DPSGD_Z} "
              f"C={DPSGD_CLIP} m={DPSGD_MICRO}{fold}, ε by round "
              f"{[round(v, 4) for v in eps]} (= a fresh RDP accountant's) "
              f"[{card}]", flush=True)
        del engine, results
        torch.cuda.empty_cache()
    engine = mechanism_engine(accountant="pld", pld_dt=DPSGD_PLD_DT,
                              **cells["dp-sgd-ghost"])
    t0 = time.perf_counter()
    budget = engine._pld_step_budget()
    pld_s = time.perf_counter() - t0
    require(budget >= steps, f"dp_sgd pld: budget {budget} steps")
    print(f"dp_mechanisms dp_sgd pld: step budget {budget} local steps "
          f"({budget // steps} rounds) at ε={DPSGD_EPSILON}, q="
          f"{BATCH_SIZE / SAMPLES_PER_CLIENT}, z={DPSGD_Z}, grid "
          f"{DPSGD_PLD_DT} ({pld_s:.1f}s on the host) [{card}]", flush=True)
    del engine

    # DP-FTRL: round-robin cohorts of m̄ = q·N, k = 1
    engine = mechanism_engine(**cells["dp-ftrl"])
    label = "dp_mechanisms dp_ftrl fused_conv_block='residual'"
    results, _, text = run_mechanism_cell(
        card, label, engine, dict(conv_block_fwd=steps,
                                  conv_block_bwd=steps))
    eps = [r.epsilon_spent for r in results]
    want = ftrl.gaussian_epsilon(FTRL_Z, MECH_DELTA)
    cohort = engine._ftrl_cohort
    require(eps == [want] + [0.0] * (len(results) - 1)
            and engine.budget_tracker.consumed_epsilon == want
            and all(r.participating_clients == cohort for r in results)
            and engine.ftrl_participations.max() == 1,
            f"{label}: ε by round {eps} (want {want} once), participants "
            f"{[r.participating_clients for r in results]}")
    print(f"{text}; z={FTRL_Z} C={CDP_CLIP} T={FTRL_T} (height "
          f"{engine._ftrl_height}, σ_node {engine._ftrl_sigma_node:.4f}), "
          f"cohort {cohort}, ε charged once {eps[0]:.4f} (= the analytic "
          f"Gaussian's), by round {[round(v, 4) for v in eps]} [{card}]",
          flush=True)
    ftrl_resume_check(card, engine)
    del engine, results
    torch.cuda.empty_cache()

    # distributed DP, fused and per-client Skellam noise
    for name in ("distributed-fused", "distributed-per-client"):
        engine = mechanism_engine(**cells[name])
        label = ("dp_mechanisms distributed dist_fuse_noise="
                 f"{cells[name]['dist_fuse_noise']}")
        results, _, text = run_mechanism_cell(
            card, label, engine, dict(conv_block_fwd=steps,
                                      conv_block_bwd=steps))
        fresh = RDPAccountant()
        plan = engine._dist_plan
        eps = []
        for r in results:
            fresh.accumulate(plan.round_rdp(r.participating_clients))
            eps.append(fresh.get_epsilon(MECH_DELTA))
        require(engine.rdp_accountant.get_epsilon(MECH_DELTA) == eps[-1]
                and np.allclose(np.cumsum([r.epsilon_spent
                                           for r in results]), eps,
                                rtol=1e-12),
                f"{label}: ε {eps} against the engine's "
                f"{engine.rdp_accountant.get_epsilon(MECH_DELTA)}")
        print(f"{text}; z={DIST_Z} C={DIST_CLIP} bits={plan.bits} "
              f"m̄={plan.expected_clients}, participants "
              f"{[r.participating_clients for r in results]}, σ of the "
              f"decoded mean {plan.central_sigma_float(plan.expected_clients):.3e}"
              f" at m̄, ε by round {[round(v, 4) for v in eps]} (= the "
              f"Skellam RDP at each realized count) [{card}]", flush=True)
        del engine, results
        torch.cuda.empty_cache()
    check_mechanism_functions(card)


def mechanism_learning_checks():
    """One learning check a mechanism at a weak budget on the 10 non-IID
    clients (3 rounds, test accuracy above 0.5): DP-SGD's microbatch fold
    on K1/K2, DP-FTRL with every client in each cohort, distributed DP."""
    from fl_tpu_torch.core.types import PrivacyConfig

    def weak(z, clip, epsilon):
        return PrivacyConfig(epsilon=epsilon, delta=MECH_DELTA,
                             max_grad_norm=clip, noise_multiplier=z)

    learning_check("residual", "dp_sgd microbatch (z=0.005, C=1)",
                   dict(dp_mode="dp_sgd", dp_sgd_impl="microbatch",
                        privacy=weak(0.005, 1.0, 1e9)))
    learning_check("residual", "dp_ftrl (z=1e-3, C=10, cohort 10, k=3, "
                   "momentum 0)",
                   dict(dp_mode="dp_ftrl", ftrl_rounds=3,
                        ftrl_max_participations=3, ftrl_momentum=0.0,
                        privacy=weak(1e-3, 10.0, 1e9)))
    learning_check("residual", "distributed (z=1e-3, C=10)",
                   dict(dp_mode="distributed",
                        privacy=weak(1e-3, 10.0, 1e12)))


def learning_check(fused, label=None, engine_cfg=None, budgets=None,
                   above=0.5, **training):
    """10 non-IID clients, 3 rounds, test accuracy above ``above`` (None:
    printed only): with Adam (the default), or with ``training`` and
    ``engine_cfg`` for the configuration ``label`` names; ``budgets`` sets
    epochs_per_client. Returns the engine."""
    import torch

    from fl_tpu_torch.data import load_dataset, make_federated_arrays
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    splits = load_dataset("mnist", n_train_synth=4096, n_test_synth=1024)
    arrays = make_federated_arrays(splits, 10, "non_iid", seed=0)
    engine = FederatedRoundEngine(
        create_model("simple_cnn", dtype=torch.bfloat16,
                     fused_conv_block=fused), arrays,
        RoundEngineConfig(training=FederatedTrainingConfig(
            **dict(dict(local_epochs=2), **training)), **(engine_cfg or {})),
        device=DEVICE, test_images=splits.normalized(splits.test_images),
        test_labels=splits.test_labels)
    if budgets is not None:
        engine.epochs_per_client = budgets
    label = label or f"fused_conv_block={fused!r}"
    accs = [r.test_accuracy for r in engine.run(num_rounds=3)]
    require(all(math.isfinite(a) for a in accs)
            and (above is None or accs[-1] > above),
            f"{label}: test accuracy after 3 rounds {accs}")
    print(f"learning {label}: 10 non-IID clients, test accuracy by round "
          f"{[round(a, 4) for a in accs]}", flush=True)
    return engine


def qffl_spread_check():
    """The reference's fairness check (tests/test_qffl.py
    test_qffl_reduces_loss_spread) on the card with the bf16 "residual"
    SimpleCNN: 4 clients of 32 images, the last a minority population
    (inverted images, labels shifted by 5), 8 rounds of 2 local SGD epochs
    (lr 0.1, batch 16). q = 3 must narrow the final per-client loss
    spread on the clients' own shards against q = 0."""
    import numpy as np
    import torch

    from fl_tpu_torch.data.federated import FederatedArrays
    from fl_tpu_torch.data.synthetic import synthetic_mnist
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    C, n = 4, 32
    xtr, ytr, _, _ = synthetic_mnist(n_train=C * n, n_test=1, seed=0)
    images = xtr.reshape(C, n, 28, 28, 1).copy()
    labels = ytr.reshape(C, n).astype(np.int32).copy()
    images[-1] = 255 - images[-1]
    labels[-1] = (labels[-1] + 5) % 10
    losses = {}
    for q in (0.0, 3.0):
        engine = FederatedRoundEngine(
            create_model("simple_cnn", dtype=torch.bfloat16,
                         fused_conv_block="residual"),
            FederatedArrays(images=images, labels=labels,
                            num_samples=np.full(C, n, np.int32),
                            mean=np.asarray([0.1307], np.float32),
                            std=np.asarray([0.3081], np.float32),
                            num_classes=10),
            RoundEngineConfig(training=FederatedTrainingConfig(
                local_epochs=2, batch_size=16, learning_rate=0.1,
                optimizer_type="sgd", momentum=0.0), qffl_q=q, seed=0),
            device=DEVICE)
        engine.run_rounds_pipelined(8)
        losses[q] = engine.evaluate_federated()["per_client"]["loss"]
    spread = {q: float(v.max() - v.min()) for q, v in losses.items()}
    require(all(np.isfinite(v).all() for v in losses.values())
            and spread[3.0] < spread[0.0],
            f"q-ffl spread: {spread} (q=3 must be below q=0)")
    print("learning q-ffl spread: 4 clients, the last a minority, 8 rounds: "
          "per-client loss " + "; ".join(
              f"q={q}: {np.round(v, 4).tolist()} spread {spread[q]:.4f}"
              for q, v in losses.items()), flush=True)


def qffl_learning_check():
    """q-FFL with local SGD (lr 0.1, the reference's q-FFL tests' rate) on
    the 10 non-IID clients: at q = QFFL_LEARN_Q test accuracy above 0.5
    after 3 rounds; q = 1 and q = 0 (uniform FedAvg) beside it, printed
    with each one's per-client accuracy spread on the clients' own shards.
    At q = 1 the step Σ F_k Δw_k / Σ h_k is about F/‖Δw‖ long when
    ‖Δw_k‖² = ‖Σ local gradients‖² outweighs L·F_k (24 local steps
    here), far shorter than FedAvg's (the port's q-FFL round equals the
    reference's on the CPU; the reference was not run at this size). Then
    the reference's spread check (qffl_spread_check)."""
    sgd = dict(optimizer_type="sgd", momentum=0.0, learning_rate=0.1)
    fed = {}
    for q in (QFFL_LEARN_Q, QFFL_Q, 0.0):
        engine = learning_check(
            "residual", f"q-ffl q={q} (sgd lr 0.1)", dict(qffl_q=q),
            above=0.5 if q == QFFL_LEARN_Q else None, **sgd)
        fed[q] = engine.evaluate_federated()
    print("learning q-ffl: per-client accuracy on own shards, " + "; ".join(
        f"q={q}: mean {f['accuracy']:.4f} min {f['accuracy_min']:.4f} std "
        f"{f['accuracy_std']:.4f}" for q, f in fed.items()), flush=True)
    qffl_spread_check()


def cifar_arrays(num_clients=NUM_CLIENTS, samples=SAMPLES_PER_CLIENT,
                 n_test=1024):
    """IID shards of synthetic CIFAR-10 (host), and the splits."""
    from fl_tpu_torch.data import load_dataset, make_federated_arrays

    splits = load_dataset("cifar10", n_train_synth=num_clients * samples,
                          n_test_synth=n_test)
    return make_federated_arrays(splits, num_clients=num_clients,
                                 strategy="iid", samples_per_client=samples,
                                 seed=0), splits


def cifar_engine(num_clients=NUM_CLIENTS, samples=SAMPLES_PER_CLIENT,
                 eps_r=EPS_R, delta_r=DELTA_R, max_grad_norm=1.0,
                 local_epochs=LOCAL_EPOCHS, test=False, model=None,
                 augment=True, dp=True, trainable_patterns=None,
                 device=DEVICE):
    """The CIFAR-10 slice's main path: the bench's round (512 IID clients x
    64 synthetic images, 5 local epochs of Adam at batch 32, lr 1e-3,
    moments in bf16, delta DP at the bench's per-round budget) with
    CIFAR10CNN(norm="batch") in bf16 and the on-device augmentation; the
    zoo's paths pass their ``model`` (and may leave out the augmentation
    or, with ``dp=False``, the DP)."""
    import torch

    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.ops.preprocess import make_cifar_augment
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    arrays, splits = cifar_arrays(num_clients, samples)
    dp_cfg = {}
    if dp:
        dp_cfg = dict(
            dp_mode="delta",
            privacy=PrivacyConfig(epsilon=1.0 if eps_r == EPS_R else 1e9,
                                  delta=1e-5, max_grad_norm=max_grad_norm),
            epsilon_per_round=eps_r, delta_per_round=delta_r)
    cfg = RoundEngineConfig(
        training=FederatedTrainingConfig(
            local_epochs=local_epochs, batch_size=BATCH_SIZE,
            learning_rate=0.001, optimizer_state_dtype="bfloat16"),
        trainable_patterns=trainable_patterns, max_clients=num_clients,
        seed=0, **dp_cfg)
    extra = {}
    if test:
        extra = dict(test_images=splits.normalized(splits.test_images),
                     test_labels=splits.test_labels)
    if model is None:
        model = create_model("cifar10_cnn", dtype=torch.bfloat16)
    return FederatedRoundEngine(
        model, arrays, cfg, device=device,
        augment_fn=make_cifar_augment() if augment else None, **extra)


def cifar_ghost_z():
    """The script's noise multiplier: RDP-calibrated to ε = 1.5 over its
    30 rounds of 16 steps at q = 256/4096."""
    from fl_tpu_torch.fl.accounting import calibrate_noise_multiplier

    steps = GHOST_PLANNED_ROUNDS * (GHOST_SAMPLES // GHOST_BATCH)
    return calibrate_noise_multiplier(GHOST_EPSILON, GHOST_DELTA,
                                      GHOST_BATCH / GHOST_SAMPLES, steps)


def cifar_ghost_engine():
    """DP-SGD ghost on CIFAR10CNN(norm="group") at the shape of
    scripts/dp_sgd_cifar_eps15.py (24 clients x 4,096 synthetic samples, 1
    local epoch at batch 256, SGD lr 0.05, bf16 compute, C = 1), under the
    RDP accountant."""
    import torch

    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    arrays, _ = cifar_arrays(GHOST_CLIENTS, GHOST_SAMPLES)
    return FederatedRoundEngine(
        create_model("cifar10_cnn", norm="group", dtype=torch.bfloat16),
        arrays,
        RoundEngineConfig(
            training=FederatedTrainingConfig(
                local_epochs=1, batch_size=GHOST_BATCH,
                learning_rate=GHOST_LR, optimizer_type="sgd"),
            dp_mode="dp_sgd", dp_sgd_impl="ghost", accountant="rdp",
            privacy=PrivacyConfig(epsilon=GHOST_EPSILON, delta=GHOST_DELTA,
                                  max_grad_norm=1.0,
                                  noise_multiplier=cifar_ghost_z()),
            max_clients=GHOST_CLIENTS, seed=0),
        device=DEVICE)


def check_k3_at_groups(groups, C):
    """K3 against its plain version at a model's DP groups (``groups`` the
    widths a client, in launch order) over C clients: σ = 0 exact to 1e-6
    relative, timed against the plain version and its bound; its noise at
    the ragged width of the last group equal to the numpy Philox oracle and
    N(0, 1) by its moments. Returns the line's text."""
    import numpy as np
    import torch

    from fl_tpu_torch.core import prng
    from fl_tpu_torch.ops import dp as dpo

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rseed = prng.round_seed(prng.root_seed(0), 1)
    data = []
    for gi, D in enumerate(groups):
        xg = torch.randn((C, D), generator=gen, device="cuda") * 1e-3
        scale = torch.rand((C,), generator=gen, device="cuda")
        seeds = torch.as_tensor(prng.as_int64(prng.client_stream_seeds(
            rseed, C, prng.Stream.DP_NOISE, gi))).cuda()
        data.append((xg, scale, seeds))
    err = 0.0
    for xg, scale, seeds in data:
        got = dpo.clip_noise_cuda(xg, scale, torch.zeros_like(scale), seeds)
        want = xg * scale[:, None]
        err = max(err, float((got - want).abs().max()))
        require(torch.allclose(got, want, rtol=1e-6, atol=0.0),
                f"K3 at a group of {xg.shape[1]}: sigma=0 output is not "
                "x*scale to 1e-6 relative")
    sig = torch.full((C,), 0.01, device="cuda")
    n = sum(xg.numel() for xg, _, _ in data)
    b_ms, b_by = bound(8 * n + len(data) * 2 * 16 * C, 10 * n, F32_FLOPS)
    ms = time_ms(lambda: [dpo.clip_noise_cuda(xg, s, sig, sd)
                          for xg, s, sd in data])
    plain = time_ms(lambda: [dpo.clip_noise_plain(xg, s, sig, sd)
                             for xg, s, sd in data], reps=2)
    del data
    # the noise at the ragged width, two real clients' seeds
    oracle = philox_oracle()
    D = groups[-1]
    seeds = prng.as_int64(prng.client_stream_seeds(
        rseed, 2, prng.Stream.DP_NOISE, len(groups) - 1))
    z = dpo.clip_noise_cuda(torch.zeros((2, D), device="cuda"),
                            torch.zeros(2, device="cuda"),
                            torch.ones(2, device="cuda"),
                            torch.as_tensor(seeds).cuda()).cpu().numpy()
    counter, word = (t.numpy() for t in dpo.noise_layout(D))
    worst = max(float(np.abs(z[c] - oracle.box_muller(seeds[c], counter,
                                                       word)).max())
                for c in range(2))
    require(worst <= 1e-5, f"K3 at width {D} differs from the Philox oracle "
            f"by {worst} (tol 1e-5)")
    flat = z.astype(np.float64).ravel()
    mean, var = float(flat.mean()), float(flat.var())
    require(abs(mean) <= 0.02 and abs(var - 1) <= 0.03,
            f"K3 at width {D}: noise mean {mean}, variance {var}")
    return (f"groups {list(groups)} x {C} clients: sigma=0 exact to 1e-6 "
            f"(max abs err {err:.1e}), the Philox oracle to {worst:.1e} at "
            f"D={D}, noise mean {mean:.2e} var {var:.4f}; {ms:.3f} ms a "
            f"round's {len(groups)} launches (plain {plain:.3f}, bound "
            f"{b_ms:.3f} by {b_by})")


def phase_cifar(card):
    """The CIFAR-10 slice on the card: the main path (CIFAR10CNN with
    BatchNorm, augmentation, per-client batch statistics, delta DP with K3
    at five groups, 512 clients; a warm-up and 2 pipelined rounds), K3 at
    those groups against its plain version, DP-SGD ghost on the GroupNorm
    model at the script's shape (ε after each round against a fresh
    accountant), and a learning check."""
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.core.pytree import tree_get, tree_leaves, tree_map
    from fl_tpu_torch.fl.accounting import RDPAccountant
    from fl_tpu_torch.fl.privacy import leaf_groups

    print(f"cifar K3 at CIFAR's "
          f"{check_k3_at_groups(CIFAR_K3_GROUPS, NUM_CLIENTS)} [{card}]",
          flush=True)

    # 1. the main path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = cifar_engine()
    build_s = time.perf_counter() - t0
    variables = engine.global_variables
    require(sum(t.numel() for t in tree_leaves(variables["params"]))
            == CIFAR_PARAMS and sum(t.numel() for t in tree_leaves(
                variables["batch_stats"])) == CIFAR_STATS,
            "CIFAR10CNN's parameter or statistics count")
    widths = tuple(sum(tree_get(variables, p).numel() for p in g)
                   for g in leaf_groups(tree_map(lambda t: t[None],
                                                 variables)))
    require(widths == CIFAR_K3_GROUPS, f"K3's groups at CIFAR {widths}")
    stats0 = [t.clone() for t in tree_leaves(variables["batch_stats"])]
    t0 = time.perf_counter()
    warm = engine.run_round(evaluate=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    results = engine.run_rounds_pipelined(CIFAR_ROUNDS, evaluate=False)
    end.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    device_ms = start.elapsed_time(end) / CIFAR_ROUNDS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = dict.fromkeys(counts, 0)
    want["clip_noise"] = len(CIFAR_K3_GROUPS) * CIFAR_ROUNDS
    require(counts == want, f"cifar: launch counts {counts}, expected "
                            f"{want}")
    losses = [warm.train_loss] + [r.train_loss for r in results]
    require(all(math.isfinite(v) for v in losses), f"cifar: losses {losses}")
    stats = tree_leaves(engine.global_variables["batch_stats"])
    require(all(bool(torch.isfinite(t).all()) for t in stats)
            and all(not torch.equal(a, b) for a, b in zip(stats, stats0)),
            "cifar: batch_stats not finite or unchanged")
    neg = sum(int((t < 0).sum()) for t in stats[1::2])
    print(f"cifar main path: CIFAR10CNN(norm='batch') bf16, augmentation, "
          f"{NUM_CLIENTS} clients x {SAMPLES_PER_CLIENT} images, delta DP "
          f"eps_r={EPS_R:.4f}, engine built in {build_s:.1f}s, warm-up "
          f"round {warm_s:.2f}s, {CIFAR_ROUNDS} pipelined rounds in "
          f"{dt:.3f}s -> {CIFAR_ROUNDS / dt:.3f} rounds/s, device span "
          f"{device_ms:.1f} ms a round (CUDA events), peak memory "
          f"{peak:.2f} GiB, launches {counts['clip_noise']} clip_noise "
          f"({counts['clip_noise'] // CIFAR_ROUNDS} a round, 0 elsewhere), "
          f"losses {[f'{v:.4g}' for v in losses]}, batch_stats finite and "
          f"moved ({neg} of {CIFAR_STATS // 2} running variances negative "
          f"under the noise) [{card}]", flush=True)
    del engine, results
    torch.cuda.empty_cache()

    # 2. DP-SGD ghost on the GroupNorm model, the script's shape
    torch.cuda.reset_peak_memory_stats()
    engine = cifar_ghost_engine()
    z = engine.privacy.noise_multiplier
    t0 = time.perf_counter()
    results = [engine.run_round(evaluate=False)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(GHOST_ROUNDS):
        results.append(engine.run_round(evaluate=False))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = GHOST_SAMPLES // GHOST_BATCH
    # the step's noise through K3, once a leaf; no other kernel
    leaves = len(tree_leaves(engine.global_variables["params"]))
    want = dict.fromkeys(counts, 0)
    want["clip_noise"] = GHOST_ROUNDS * steps * leaves
    require(counts == want, f"cifar ghost: launches {counts}, expected "
                            f"{want}")
    fresh = RDPAccountant()
    eps = []
    for i, entry in enumerate(engine.accountant.get_privacy_ledger()):
        fresh.step(GHOST_BATCH / GHOST_SAMPLES, z, steps)
        want_eps = fresh.get_epsilon(GHOST_DELTA)
        require(entry["metadata"]["total_epsilon"] == want_eps,
                f"cifar ghost: round {i} ε {entry['metadata']} against a "
                f"fresh accountant's {want_eps}")
        eps.append(want_eps)
    require(len(eps) == len(results)
            and engine.certified_epsilon() == eps[-1],
            f"cifar ghost: certified {engine.certified_epsilon()}, ε {eps}")
    losses = [r.train_loss for r in results]
    require(all(math.isfinite(v) for v in losses),
            f"cifar ghost: losses {losses}")
    print(f"cifar dp_sgd ghost: CIFAR10CNN(norm='group') bf16, "
          f"{GHOST_CLIENTS} clients x {GHOST_SAMPLES} samples, batch "
          f"{GHOST_BATCH} ({steps} steps a round), SGD lr {GHOST_LR}, C=1, "
          f"z={z:.4f}, warm-up round {warm_s:.2f}s, {GHOST_ROUNDS} rounds in "
          f"{dt:.3f}s -> {GHOST_ROUNDS / dt:.3f} rounds/s, peak memory "
          f"{peak:.2f} GiB, launches {counts['clip_noise']} clip_noise "
          f"({leaves} a step, 0 elsewhere), losses "
          f"{[round(v, 4) for v in losses]}, ε by round "
          f"{[round(v, 4) for v in eps]} (= a fresh RDP accountant's) "
          f"[{card}]", flush=True)
    del engine, results
    torch.cuda.empty_cache()

    # 3. learning: 10 IID clients, weak delta DP, eval on the running
    # statistics. The main path's 5 local epochs (80 steps a round): at
    # momentum 0.99 the running statistics lag the moving weights, and
    # with 2 epochs an H100 read 0.668 in the third round after 0.969
    engine = cifar_engine(num_clients=10, samples=512, eps_r=1e8,
                          delta_r=1e-7, max_grad_norm=100.0, test=True)
    accs = [r.test_accuracy for r in engine.run(num_rounds=3)]
    require(all(math.isfinite(a) for a in accs) and accs[-1] > 0.5,
            f"cifar learning: test accuracy after 3 rounds {accs}")
    print(f"learning cifar10_cnn(norm='batch') bf16 + augmentation, weak "
          f"delta DP: 10 IID clients, test accuracy by round (running "
          f"statistics) {[round(a, 4) for a in accs]}", flush=True)
    del engine
    torch.cuda.empty_cache()


def zoo_resnet_engine(num_clients=ZOO_RESNET_CLIENTS, **kw):
    """The zoo's main path: ``get_model_for_dataset("cifar100")`` (the
    ResNet at 100 classes) in bf16 with the CIFAR augmentation, on the
    synthetic CIFAR-10 arrays (labels 0-9 are valid among 100), the
    bench's training options and delta DP."""
    import torch

    from fl_tpu_torch.models import get_model_for_dataset

    return cifar_engine(num_clients, model=get_model_for_dataset(
        "cifar100", dtype=torch.bfloat16), **kw)


def zoo_vit_engine(num_clients=NUM_CLIENTS, **kw):
    """Federated fine-tuning: the default FederatedViT with rank-4 LoRA
    adapters in bf16, only ``lora_trainable_patterns()`` trained."""
    import torch

    from fl_tpu_torch.fl.peft import lora_trainable_patterns
    from fl_tpu_torch.models import create_model

    return cifar_engine(num_clients, model=create_model(
        "federated_vit", lora_rank=4, dtype=torch.bfloat16), augment=False,
        trainable_patterns=lora_trainable_patterns(), **kw)


def zoo_mobilenet_engine(num_clients=NUM_CLIENTS, **kw):
    """``get_lightweight_model()`` (LightweightMobileNet at width 0.5) in
    bf16."""
    import torch

    from fl_tpu_torch.models import get_lightweight_model

    return cifar_engine(num_clients, model=get_lightweight_model(
        dtype=torch.bfloat16), augment=False, **kw)


def run_zoo_cell(card, label, make_engine, rounds, groups, params,
                 warmup=True):
    """Build a zoo engine (its parameter count and, under delta DP, K3's
    group widths checked), run a warm-up round and ``rounds`` pipelined
    rounds with the launch counts read around them: K3 ``len(groups)``
    times a round, nothing else. Prints rounds/s, the device span a round
    (CUDA events), peak memory, the launches and the losses; returns the
    engine."""
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.core.pytree import tree_get, tree_leaves, tree_map
    from fl_tpu_torch.fl.privacy import leaf_groups

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = make_engine()
    build_s = time.perf_counter() - t0
    variables = engine.global_variables
    n = sum(t.numel() for t in tree_leaves(variables["params"]))
    require(n == params, f"{label}: {n} parameters, expected {params}")
    if groups:
        widths = tuple(sum(tree_get(variables, p).numel() for p in g)
                       for g in leaf_groups(tree_map(lambda t: t[None],
                                                     variables)))
        require(widths == groups, f"{label}: K3's groups {widths}, "
                f"expected {groups}")
    losses, warm_s = [], 0.0
    if warmup:
        t0 = time.perf_counter()
        losses.append(engine.run_round(evaluate=False).train_loss)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    results = engine.run_rounds_pipelined(rounds, evaluate=False)
    end.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = dict.fromkeys(counts, 0)
    want["clip_noise"] = len(groups) * rounds
    require(counts == want, f"{label}: launch counts {counts}, expected "
                            f"{want}")
    losses += [r.train_loss for r in results]
    require(all(math.isfinite(v) for v in losses),
            f"{label}: losses {losses}")
    print(f"zoo {label}: engine built in {build_s:.1f}s, warm-up round "
          f"{warm_s:.2f}s, {rounds} pipelined rounds in {dt:.3f}s -> "
          f"{rounds / dt:.3f} rounds/s, device span "
          f"{start.elapsed_time(end) / rounds:.1f} ms a round (CUDA "
          f"events), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, launches "
          f"{counts['clip_noise']} clip_noise ({len(groups)} a round, 0 "
          f"elsewhere), losses {[f'{v:.4g}' for v in losses]} [{card}]",
          flush=True)
    return engine


def check_lora_merge(card, engine):
    """``merge_lora`` of a fine-tuned ViT's global params: the merged tree's
    forward equals the unmerged one on 256 test images, in f32 to f32
    rounding and in bf16 within bf16 rounding; the adapters come back
    zero."""
    import torch

    from fl_tpu_torch.core.pytree import tree_leaves, tree_map, tree_paths
    from fl_tpu_torch.data import load_dataset
    from fl_tpu_torch.fl.peft import merge_lora
    from fl_tpu_torch.models import create_model

    params = engine.global_variables["params"]
    moved = sum(float(t.abs().sum()) for p, t in zip(
        tree_paths(params), tree_leaves(params)) if p[-1] == "lora_b")
    require(moved > 0, "zoo vit: the LoRA B matrices never moved")
    merged = merge_lora(params)
    require(all(not t.any() for p, t in zip(tree_paths(merged),
                                            tree_leaves(merged))
                if p[-1].startswith("lora_")),
            "zoo vit: merge_lora left adapters non-zero")
    splits = load_dataset("cifar10", n_train_synth=256, n_test_synth=256)
    x = torch.as_tensor(splits.normalized(splits.test_images)).to(
        engine.device)[None]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = create_model("federated_vit", lora_rank=4, dtype=dtype)
        with torch.no_grad():
            a = model(tree_map(lambda t: t[None], params), x)
            b = model(tree_map(lambda t: t[None], merged), x)
        errs[dtype] = (float((a - b).abs().max() / a.abs().max()),
                       float((a - b).norm() / a.norm()))
    f32, bf16 = errs[torch.float32][0], errs[torch.bfloat16][1]
    require(f32 <= MERGE_F32_TOL and bf16 <= MERGE_BF16_TOL,
            f"zoo vit: merged forward differs: f32 {f32} (tol "
            f"{MERGE_F32_TOL}), bf16 {bf16} (tol {MERGE_BF16_TOL})")
    return (f"merge_lora: adapters zeroed, merged vs unmerged logits on "
            f"256 test images: f32 max |diff| {f32:.2e} of the largest "
            f"logit, bf16 relative Frobenius {bf16:.2e} [{card}]")


def resnet_learning_check(device=DEVICE):
    """10 IID clients x 512 synthetic CIFAR images, the ResNet at 100
    classes in bf16 with augmentation, weak delta DP, 3 rounds; returns
    the test accuracy by round (on the running statistics)."""
    engine = zoo_resnet_engine(num_clients=10, samples=512, eps_r=1e8,
                               delta_r=1e-7, max_grad_norm=100.0, test=True,
                               device=device)
    return [r.test_accuracy for r in engine.run(num_rounds=3)]


def vit_learning_check(device=DEVICE):
    """10 IID clients x 512 synthetic CIFAR images, the default ViT
    (dropout 0.1, no adapters) in bf16, weak delta DP, 3 rounds; returns
    the (train loss, test accuracy) by round."""
    import torch

    from fl_tpu_torch.models import create_model

    engine = cifar_engine(10, samples=512, eps_r=1e8, delta_r=1e-7,
                          max_grad_norm=100.0, test=True, augment=False,
                          model=create_model("federated_vit",
                                             dtype=torch.bfloat16),
                          device=device)
    return [(r.train_loss, r.test_accuracy) for r in engine.run(num_rounds=3)]


def phase_zoo(card):
    """The rest of the model zoo on the card: the ResNet main path (128
    clients, K3 at nine groups), the ViT with LoRA (512 clients, K3 at one
    group; a round without DP keeps every frozen leaf's bits; merge_lora),
    the MobileNet (512 clients), K3 at the ResNet's groups against its
    plain version, ``benchmark_models`` and two learning checks."""
    import torch

    from fl_tpu_torch.core.pytree import flatten_dict, tree_leaves
    from fl_tpu_torch.models import benchmark_models

    print(f"zoo K3 at the ResNet's "
          f"{check_k3_at_groups(RESNET_K3_GROUPS, ZOO_RESNET_CLIENTS)} "
          f"[{card}]", flush=True)

    # 1. the main path: the cifar100 route's ResNet
    engine = run_zoo_cell(
        card, f"resnet main path: get_model_for_dataset('cifar100') bf16, "
        f"augmentation, {ZOO_RESNET_CLIENTS} clients x {SAMPLES_PER_CLIENT} "
        f"images, delta DP eps_r={EPS_R:.4f}", zoo_resnet_engine,
        ZOO_ROUNDS, RESNET_K3_GROUPS, RESNET_PARAMS)
    stats = tree_leaves(engine.global_variables["batch_stats"])
    require(len(stats) == 30 and sum(t.numel() for t in stats)
            == RESNET_STATS and all(bool(torch.isfinite(t).all())
                                    for t in stats),
            "zoo resnet: batch_stats not 30 finite leaves of 4,480")
    neg = sum(int((t < 0).sum()) for t in stats[1::2])
    print(f"zoo resnet batch_stats: 30 leaves finite, {neg} of "
          f"{RESNET_STATS // 2} running variances negative under the "
          f"noise", flush=True)
    del engine
    torch.cuda.empty_cache()

    # 2. federated fine-tuning: the ViT with LoRA under delta DP, then a
    # round without DP whose frozen leaves keep their bits
    vit_groups = (VIT_LORA_PARAMS,)
    engine = run_zoo_cell(
        card, f"vit-lora: federated_vit(lora_rank=4) bf16, "
        f"lora_trainable_patterns(), {NUM_CLIENTS} clients, delta DP "
        f"eps_r={EPS_R:.4f}", zoo_vit_engine, ZOO_ROUNDS, vit_groups,
        VIT_LORA_PARAMS)
    del engine
    torch.cuda.empty_cache()
    init = {}

    def no_dp_engine():
        eng = zoo_vit_engine(dp=False)
        init.update((k, v.clone()) for k, v in flatten_dict(
            eng.global_variables["params"]).items())
        return eng

    engine = run_zoo_cell(card, f"vit-lora without DP: {NUM_CLIENTS} "
                          "clients, one round", no_dp_engine, 1, (),
                          VIT_LORA_PARAMS, warmup=False)
    mask = flatten_dict(engine._grad_mask)
    frozen = [k for k in init if not mask[k].any()]
    after = flatten_dict(engine.global_variables["params"])
    require(all(torch.equal(after[k], init[k]) for k in frozen),
            "zoo vit: a frozen leaf moved in a round without DP")
    trained = [k for k in init if k not in frozen]
    moved = sum(not torch.equal(after[k], init[k]) for k in trained)
    require(moved > 0, "zoo vit: no trainable leaf moved")
    print(f"zoo vit-lora frozen: {len(frozen)} frozen leaves bit-equal "
          f"after the round, {moved} of {len(trained)} trainable leaves "
          f"moved; {check_lora_merge(card, engine)}", flush=True)
    del engine
    torch.cuda.empty_cache()

    # 3. the MobileNet, the factory's lightweight preset
    engine = run_zoo_cell(
        card, f"mobilenet: get_lightweight_model() bf16, {NUM_CLIENTS} "
        f"clients, delta DP eps_r={EPS_R:.4f}", zoo_mobilenet_engine, 1,
        (MOBILENET_PARAMS + MOBILENET_STATS,), MOBILENET_PARAMS)
    del engine
    torch.cuda.empty_cache()

    # 4. every model's forward, timed on the card
    bench = benchmark_models(batch_size=BATCH_SIZE, iters=ZOO_BENCH_ITERS)
    errors = {k: v["error"] for k, v in bench.items() if "error" in v}
    require(not errors, f"benchmark_models: {errors}")
    print(f"zoo benchmark_models (one client x {BATCH_SIZE} images, eval "
          f"forward, CUDA events over {ZOO_BENCH_ITERS} after a warm-up): "
          + ", ".join(f"{k} {1e3 * v['inference_time']:.3f} ms"
                      for k, v in bench.items()) + f" [{card}]", flush=True)

    # 5. learning
    accs = resnet_learning_check()
    require(all(math.isfinite(a) for a in accs) and accs[-1] > 0.5,
            f"zoo resnet learning: test accuracy after 3 rounds {accs}")
    print(f"learning federated_resnet (cifar100 route) bf16 + augmentation, "
          f"weak delta DP: 10 IID clients x 512, test accuracy by round "
          f"(running statistics) {[round(a, 4) for a in accs]}", flush=True)
    hist = vit_learning_check()
    require(all(math.isfinite(v) for h in hist for v in h)
            and hist[-1][0] < hist[0][0],
            f"zoo vit learning: (train loss, test accuracy) {hist}")
    print(f"learning federated_vit bf16, weak delta DP: 10 IID clients x "
          f"512, train loss by round {[round(h[0], 4) for h in hist]}, test "
          f"accuracy {[round(h[1], 4) for h in hist]}", flush=True)
    torch.cuda.empty_cache()


MESH_ROUNDS = 3          # pipelined, after a warm-up round
MESH_RANKS = 2           # gloo ranks sharing the one card


def mesh_engine(mesh=None, arrays=None):
    """The 512-client bf16 delta-DP bench engine (``"residual"``), on the
    card or on ``mesh``."""
    from fl_tpu_torch.core.types import PrivacyConfig
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    cfg = RoundEngineConfig(
        training=bench_training(), dp_mode="delta",
        privacy=PrivacyConfig(epsilon=1.0, delta=1e-5, max_grad_norm=1.0),
        epsilon_per_round=EPS_R, delta_per_round=DELTA_R,
        max_clients=NUM_CLIENTS, seed=0)
    return FederatedRoundEngine(
        bench_model("residual"), arrays or bench_arrays(), cfg,
        device=None if mesh is not None else DEVICE, mesh=mesh)


def mesh_rounds(engine, trace_dir=None):
    """A warm-up round, then MESH_ROUNDS pipelined ones: returns (the
    launch counts of the pipelined rounds, rounds/s, peak memory in GiB,
    the losses with the warm-up's first, the collectives of the last
    round, the weights on the host, and with ``trace_dir``
    :func:`mesh_entry_points`' results, else None)."""
    import torch

    from fl_tpu_torch import ops

    torch.cuda.reset_peak_memory_stats()
    warm = engine.run_round(evaluate=False)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run_rounds_pipelined(MESH_ROUNDS, evaluate=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    return (counts, MESH_ROUNDS / dt,
            torch.cuda.max_memory_allocated() / 2 ** 30,
            [r.train_loss for r in [warm] + results],
            list(engine.round_collectives),
            {k: v.cpu() for k, v in engine.get_model_weights().items()},
            None if trace_dir is None
            else mesh_entry_points(engine, trace_dir))


def mesh_entry_points(engine, trace_dir):
    """``evaluate_personalized`` (one fine-tune epoch) and ``profile_round``
    after the rounds: (their launches, the per-client arrays, the summary,
    the seconds of each, the profiled round's loss, the trace's bytes and
    path). ``trace_dir=""`` runs the round through ``run_round`` instead
    (the unsharded reference of the ranks' profiled round)."""
    import torch

    from fl_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pers = engine.evaluate_personalized()
    t1 = time.perf_counter()
    if trace_dir:
        prof = engine.profile_round(trace_dir)
        path = engine.last_trace_path
    else:
        prof, path = engine.run_round(evaluate=False), None
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    return (counts, pers.pop("per_client"), pers, (t1 - t0, t2 - t1),
            prof.train_loss, os.path.getsize(path) if path else 0, path)


def mesh_rank_job(mesh, trace_dir):
    """One gloo rank's share of the bench round and of the entry points
    after it (``phase_mesh``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return mesh_rounds(mesh_engine(mesh), trace_dir)


def check_mesh_counts(label, counts):
    steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
    want = {"conv_block_fwd": steps * MESH_ROUNDS,
            "conv_block_bwd": steps * MESH_ROUNDS,
            "clip_noise": 2 * MESH_ROUNDS}
    require(counts == want, f"{label}: launches {counts}, expected {want}")


# evaluate_personalized: 2 fine-tune steps and 2 holdout forwards;
# profile_round: one round
MESH_ENTRY_LAUNCHES = {"conv_block_fwd": 2 + 2 + 10, "conv_block_bwd": 2 + 10,
                       "clip_noise": 2}


def check_mesh_entry_points(label, got, want):
    """A rank's ``evaluate_personalized`` and ``profile_round`` against the
    unsharded engine's: the same launches, holdout sizes and summary keys;
    the per-client accuracies equal on at least 95% of the clients and the
    mean accuracies within 0.01 (the model is the bench's noise, σ ≈ 154
    an element, and the ranks' weights differ from the unsharded ones by
    ulps of it, which can flip an argmax at a near-tie); the profiled
    round's loss within 1e-4. Returns the text of its line."""
    import numpy as np

    counts, per, summary, secs, loss, nbytes, _ = got
    require(counts == MESH_ENTRY_LAUNCHES,
            f"{label}: entry points' launches {counts}, expected "
            f"{MESH_ENTRY_LAUNCHES}")
    require(set(summary) == set(want[2]) and set(per) == set(want[1])
            and np.array_equal(per["n_holdout"], want[1]["n_holdout"])
            and per["n_holdout"].shape == (NUM_CLIENTS,),
            f"{label}: evaluate_personalized's keys or holdout sizes differ")
    same = {k: float(np.mean(per[k] == want[1][k]))
            for k in ("global_accuracy", "personalized_accuracy")}
    gaps = {k: abs(summary[k] - want[2][k])
            for k in ("mean_global_accuracy", "mean_personalized_accuracy")}
    require(min(same.values()) >= 0.95 and max(gaps.values()) <= 0.01,
            f"{label}: per-client accuracies equal on {same}, mean gaps "
            f"{gaps}")
    rel = abs(loss - want[4]) / abs(want[4])
    require(rel <= 1e-4 and nbytes > 0,
            f"{label}: profiled loss {loss} against {want[4]}, trace "
            f"{nbytes} B")
    return (f"evaluate_personalized {secs[0]:.2f}s (gain "
            f"{summary['mean_personalization_gain']:+.4f}, accuracies equal "
            f"to the unsharded on {100 * min(same.values()):.1f}% of the "
            f"clients), profile_round {secs[1]:.2f}s (loss rel. gap "
            f"{rel:.1e}, trace {nbytes / 2 ** 20:.1f} MiB)")


def phase_mesh(card):
    """The client axis over ranks (``core.mesh``, ``parallel``): the bench
    round unsharded, on a one-rank NCCL mesh (the same code with the
    identity sum: equal bit for bit, two all-reduces a round), and on two
    gloo ranks sharing the card (CUDA tensors through gloo), held to the
    unsharded round: each leaf within 1e-6 + 1e-5 of its largest weight
    (the noised sum's scale), the warm-up round's loss within 1e-5
    relative and the noise-destroyed model's later losses within 1e-4.
    After the rounds each gloo rank runs ``evaluate_personalized`` and
    ``profile_round`` (one trace a rank under ``rank<r>``), held by
    :func:`check_mesh_entry_points` to the unsharded engine's
    ``evaluate_personalized`` and the same round through ``run_round``. Every rank must
    launch K1, K2 and K3; a failing rank fails the run. Returns the
    entry points' launches on the ranks."""
    import tempfile

    import torch
    import torch.distributed as dist

    from fl_tpu_torch.core.mesh import make_mesh, spawn

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="fl_mesh_traces_")
    arrays = bench_arrays()
    plain = mesh_rounds(mesh_engine(arrays=arrays), "")
    check_mesh_counts("mesh unsharded", plain[0])
    require(plain[6][0] == MESH_ENTRY_LAUNCHES,
            f"mesh unsharded: entry points' launches {plain[6][0]}")
    torch.cuda.empty_cache()

    mesh = make_mesh()
    require(mesh.world_size == 1 and mesh.backend == "nccl",
            f"mesh: {mesh}")
    one = mesh_rounds(mesh_engine(mesh, arrays))
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    check_mesh_counts("mesh nccl world_size=1", one[0])
    require(one[3] == plain[3]
            and all(torch.equal(one[5][k], v) for k, v in plain[5].items()),
            "mesh nccl world_size=1: the rounds differ from the unsharded "
            f"ones (losses {one[3]} against {plain[3]})")
    calls = one[4]
    require([c.kind for c in calls] == ["all_reduce", "all_reduce"]
            and calls[0].nbytes == 4 * N_PARAMS
            and sum(c.nbytes for c in calls) <= 1_800_000,
            f"mesh nccl world_size=1: collectives a round {calls}")
    print(f"mesh nccl world_size=1: {NUM_CLIENTS} clients bf16 delta-DP "
          f"'residual', {MESH_ROUNDS} pipelined rounds {one[1]:.3f} "
          f"rounds/s (unsharded {plain[1]:.3f} in this call), peak memory "
          f"{one[2]:.2f} GiB (unsharded {plain[2]:.2f}), weights and losses "
          f"equal to the unsharded ones bit for bit, collectives a round "
          f"{[(c.kind, c.dtype, c.nbytes) for c in calls]}, launches "
          f"{one[0]} [{card}]", flush=True)

    t0 = time.perf_counter()
    ranks = spawn(mesh_rank_job, MESH_RANKS, os.path.join(tmp.name, "mesh"),
                  backend="gloo", device="cuda:0")
    spawn_s = time.perf_counter() - t0
    text = []
    for r, got in enumerate(ranks):
        check_mesh_counts(f"mesh gloo rank {r}", got[0])
        require([c.kind for c in got[4]] == ["all_reduce", "all_reduce"],
                f"mesh gloo rank {r}: collectives a round {got[4]}")
        # rtol against each leaf's largest weight: a weight of the noised
        # round is a sum of 512 terms of the noise's scale (σ ≈ 154 an
        # element), and one near zero is a cancellation among them, which
        # another summation order moves by ulps of those terms
        worst = elementwise = 0.0
        for k, v in plain[5].items():
            a, b = got[5][k].float(), v.float()
            gap = float((a - b).abs().max())
            require(gap <= 1e-6 + 1e-5 * float(b.abs().max()),
                    f"mesh gloo rank {r}: {k} differs from the unsharded "
                    f"round by {gap} (its largest weight "
                    f"{float(b.abs().max())})")
            worst = max(worst, gap)
            elementwise += float(((a - b).abs()
                                  <= 1e-6 + 1e-5 * b.abs()).sum())
        elementwise /= sum(v.numel() for v in plain[5].values())
        # the warm-up round's loss is the clients' on the initial model;
        # after it the model is the bench's noise (σ ≈ 154 an element), and
        # its losses, 1e7–1e9, are differences of logits that large
        rel = [abs(x - y) / abs(y) for x, y in zip(got[3], plain[3])]
        require(rel[0] <= 1e-5 and max(rel) <= 1e-4,
                f"mesh gloo rank {r}: losses {got[3]} against {plain[3]}")
        entry = check_mesh_entry_points(f"mesh gloo rank {r}", got[6],
                                        plain[6])
        require(os.path.basename(os.path.dirname(got[6][6])) == f"rank{r}",
                f"mesh gloo rank {r}: trace at {got[6][6]}")
        text.append(f"rank {r}: {NUM_CLIENTS // MESH_RANKS} clients, "
                    f"{got[1]:.3f} rounds/s, peak memory {got[2]:.2f} GiB, "
                    f"launches {got[0]}, max |w - w_unsharded| {worst:.2e} "
                    f"({100 * elementwise:.3f}% of the weights within rtol "
                    f"1e-5 / atol 1e-6 element by element), losses' rel. "
                    f"gaps {[f'{v:.1e}' for v in rel]}; {entry}")
    require(all(torch.equal(ranks[0][5][k], v)
                for k, v in ranks[1][5].items()),
            "mesh gloo: the ranks' global models differ")
    tmp.cleanup()
    print(f"mesh gloo world_size={MESH_RANKS} on one card (CUDA tensors "
          f"through gloo; spawn and both ranks {spawn_s:.1f}s): "
          + "; ".join(text) + f"; unsharded evaluate_personalized "
          f"{plain[6][3][0]:.2f}s, the same round unprofiled "
          f"{plain[6][3][1]:.2f}s; phase {time.perf_counter() - t_phase:.1f}s"
          f" [{card}]", flush=True)
    launched = {}
    for got in ranks:
        for k, v in got[6][0].items():
            launched[k] = launched.get(k, 0) + v
    return launched


# ---------------------------------------------------------------------------
# the clustered (IFCA), Ditto and async (FedBuff) engines
# ---------------------------------------------------------------------------

ENGINE_ROUNDS = 3        # timed rounds / (round, step) pairs, after a warm-up
IFCA_K = 4
DITTO_LAM = 0.1
FEDBUFF_K = 64           # buffer_size
FEDBUFF_STALENESS = 8    # max_staleness: a ring of 9 versions
FEDBUFF_STEPS = 4        # timed server steps, after a warm-up step
ENGINE_ROWS = slice(0, NUM_CLIENTS, 32)  # personal rows held across ranks


def _tree_clone(tree):
    import torch

    from fl_tpu_torch.core.pytree import tree_map

    return tree_map(torch.clone, tree)


def host_tree(tree):
    from fl_tpu_torch.core.pytree import tree_map

    return tree_map(lambda t: t.detach().cpu(), tree)


def _tree_equal(a, b) -> bool:
    import torch

    from fl_tpu_torch.core.pytree import flatten_dict

    fa, fb = flatten_dict(a), flatten_dict(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                          for k in fa)


def _rows_digest(tree, rows) -> str:
    """sha256 of every leaf's rows ``rows`` (sorted keys): two ranks' or
    two processes' copies are equal bit for bit when their digests are."""
    import hashlib

    from fl_tpu_torch.core.pytree import flatten_dict

    h = hashlib.sha256()
    for k, v in sorted(flatten_dict(tree).items()):
        h.update(k.encode())
        h.update(v[rows].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _leaf_gaps(label, got, want):
    """Every leaf of ``got`` within 1e-5 of ``want``'s largest weight (+
    1e-6), the mesh phase's bound; returns the largest gap."""
    from fl_tpu_torch.core.pytree import flatten_dict

    g, w = flatten_dict(got), flatten_dict(want)
    require(g.keys() == w.keys(), f"{label}: trees differ {sorted(g)}")
    worst = 0.0
    for k, v in w.items():
        a, b = g[k].float().to(v.device), v.float()
        gap = float((a - b).abs().max())
        top = float(b.abs().max())
        require(gap <= 1e-6 + 1e-5 * top,
                f"{label}: {k} off by {gap} (its largest weight {top})")
        worst = max(worst, gap)
    return worst


def _launched(**want):
    """The launches since the last reset, required equal to ``want`` (0
    for every kernel not named)."""
    from fl_tpu_torch import ops

    got = ops.launch_counts()
    full = dict.fromkeys(got, 0)
    full.update(want)
    return got, got == full


def ifca_engine(arrays=None, mesh=None, **cfg):
    """IFCA over the bench's 512 clients, model and training (no DP)."""
    from fl_tpu_torch.fl import ClusteredConfig, ClusteredFederatedEngine

    cfg.setdefault("num_clusters", IFCA_K)
    cfg.setdefault("training", bench_training())
    return ClusteredFederatedEngine(
        bench_model("residual"), arrays or bench_arrays(),
        ClusteredConfig(seed=0, **cfg),
        mesh=mesh, device=None if mesh is not None else DEVICE)


def fedbuff_engine(arrays=None):
    from fl_tpu_torch.fl import AsyncConfig, AsyncFederatedEngine

    return AsyncFederatedEngine(
        bench_model("residual"), arrays or bench_arrays(),
        AsyncConfig(training=bench_training(), buffer_size=FEDBUFF_K,
                    max_staleness=FEDBUFF_STALENESS, seed=0),
        device=DEVICE)


def engines_ifca(card, arrays, tmp):
    """IFCA at k = 4: a warm-up round, ENGINE_ROUNDS timed ones (K1 = k
    assignment forwards + 10 training forwards a round, K2 = 10), an
    empty cluster bit for bit, a checkpoint's next round bit for bit.
    Returns (launches, the warm-up round's models and assignments: the
    2-rank run's reference)."""
    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.core.pytree import tree_map
    from fl_tpu_torch.orchestration.checkpoint import (
        restore_clustered_checkpoint, save_clustered_checkpoint)

    steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
    engine = ifca_engine(arrays)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = engine.run_round()
    warm_s = time.perf_counter() - t0
    reference = (_tree_clone(engine.cluster_variables),
                 engine.assignments.copy(), warm)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run(ENGINE_ROUNDS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got, ok = _launched(conv_block_fwd=ENGINE_ROUNDS * (IFCA_K + steps),
                        conv_block_bwd=ENGINE_ROUNDS * steps)
    require(ok, f"engines ifca: launches {got}")
    total = dict(got)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [r.train_loss for r in [warm] + results]
    require(all(math.isfinite(v) for v in losses)
            and all(bool(torch.isfinite(t).all()) for t in
                    engine.cluster_variables["params"]["fc2"].values()),
            f"engines ifca: losses {losses}")
    require(all(sum(r.cluster_sizes) == NUM_CLIENTS for r in results),
            "engines ifca: cluster sizes do not add up")
    print(f"engines ifca k={IFCA_K}: {NUM_CLIENTS} clients bf16 "
          f"'residual', warm-up round {warm_s:.2f}s, {ENGINE_ROUNDS} rounds "
          f"in {dt:.3f}s -> {ENGINE_ROUNDS / dt:.3f} rounds/s, peak memory "
          f"{peak:.2f} GiB, cluster sizes by round "
          f"{[r.cluster_sizes for r in [warm] + results]}, train loss "
          f"{[round(v, 4) for v in losses]}, assignment loss "
          f"{[round(r.assignment_loss, 4) for r in [warm] + results]}, "
          f"launches a round K1 {got['conv_block_fwd'] // ENGINE_ROUNDS} "
          f"(k={IFCA_K} assignment forwards + {steps} training), K2 "
          f"{got['conv_block_bwd'] // ENGINE_ROUNDS} [{card}]", flush=True)

    # the last cluster a copy of the one before it: every tie goes to the
    # first index, so nobody adopts it and it passes the round bit for bit
    last = IFCA_K - 1
    engine.cluster_variables = tree_map(
        lambda v: torch.cat([v[:last], v[last - 1:last]]),
        engine.cluster_variables)
    before = _tree_clone(engine.cluster_model(last))
    ops.reset_launch_counts()
    r = engine.run_round()
    for k, v in ops.launch_counts().items():
        total[k] = total.get(k, 0) + v
    require(r.cluster_sizes[last] == 0
            and _tree_equal(engine.cluster_model(last), before),
            f"engines ifca: the duplicated cluster took clients "
            f"({r.cluster_sizes}) or changed")

    ckpt = os.path.join(tmp, "ifca")
    t0 = time.perf_counter()
    save_clustered_checkpoint(engine, ckpt)
    save_s = time.perf_counter() - t0
    engine.run_round()
    after = (_tree_clone(engine.cluster_variables), engine.assignments.copy())
    t0 = time.perf_counter()
    step = restore_clustered_checkpoint(engine, ckpt)
    restore_s = time.perf_counter() - t0
    engine.run_round()
    require(_tree_equal(engine.cluster_variables, after[0])
            and np.array_equal(engine.assignments, after[1]),
            "engines ifca: the round after a restore differs from the "
            "uninterrupted one")
    print(f"engines ifca empty cluster: cluster {last} (a copy of cluster "
          f"{last - 1}) adopted by no client, bit for bit after the round "
          f"(sizes {r.cluster_sizes}); checkpoint of {IFCA_K} models saved "
          f"in {save_s:.3f}s, restored at round {step} in {restore_s:.3f}s, "
          f"the next round equal to the uninterrupted one bit for bit "
          f"(models, assignments) [{card}]", flush=True)
    del engine
    torch.cuda.empty_cache()
    return total, reference


def engines_ditto(card, tmp):
    """Ditto at λ = 0.1 beside the bench engine (delta DP, K3): a warm-up
    (round, step) pair, ENGINE_ROUNDS timed pairs, ``evaluate_personal``,
    a checkpoint of both. Returns (launches, the engine and the
    personalizer, the warm-up pair's reference for the 2-rank run)."""
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.core.pytree import tree_leaves, tree_map
    from fl_tpu_torch.fl import DittoPersonalizer
    from fl_tpu_torch.orchestration.checkpoint import (
        restore_ditto_checkpoint, restore_engine_checkpoint,
        save_ditto_checkpoint, save_engine_checkpoint)

    steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
    engine = make_bench_engine("residual")
    ditto = DittoPersonalizer(engine, lam=DITTO_LAM)
    torch.cuda.reset_peak_memory_stats()
    engine.run_round(evaluate=False)
    m0 = ditto.step()
    reference = (_tree_clone(engine.global_variables), m0,
                 tree_map(lambda t: t[ENGINE_ROWS].clone(),
                          ditto.personal_variables))
    ops.reset_launch_counts()
    round_s = step_s = 0.0
    metrics = [m0]
    for _ in range(ENGINE_ROUNDS):
        t0 = time.perf_counter()
        engine.run_round(evaluate=False)
        t1 = time.perf_counter()
        metrics.append(ditto.step())
        t2 = time.perf_counter()
        round_s += t1 - t0
        step_s += t2 - t1
    got, ok = _launched(conv_block_fwd=ENGINE_ROUNDS * 2 * steps,
                        conv_block_bwd=ENGINE_ROUNDS * 2 * steps,
                        clip_noise=ENGINE_ROUNDS * 2)
    require(ok, f"engines ditto: launches {got}")
    total = dict(got)
    pair = (f"K1 {got['conv_block_fwd'] // ENGINE_ROUNDS} K2 "
            f"{got['conv_block_bwd'] // ENGINE_ROUNDS} K3 "
            f"{got['clip_noise'] // ENGINE_ROUNDS}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(all(math.isfinite(m["personal_loss"]) for m in metrics)
            and all(bool(torch.isfinite(t).all()) for t in
                    ditto.personal_variables["params"]["fc2"].values()),
            f"engines ditto: personal metrics {metrics}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ev = ditto.evaluate_personal()
    eval_s = time.perf_counter() - t0
    got, ok = _launched(conv_block_fwd=2)
    require(ok and ev["per_client"]["accuracy"].shape == (NUM_CLIENTS,),
            f"engines ditto evaluate_personal: launches {got}")
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    gb = nbytes(*tree_leaves(ditto.personal_variables)) / 1e9
    personal = [float(f"{m['personal_loss']:.4g}") for m in metrics]
    print(f"engines ditto lam={DITTO_LAM}: beside the {NUM_CLIENTS}-client "
          f"bf16 delta-DP bench engine, {ENGINE_ROUNDS} (round, step) pairs "
          f"after a warm-up: rounds {ENGINE_ROUNDS / round_s:.3f}/s, steps "
          f"{ENGINE_ROUNDS / step_s:.3f}/s, together "
          f"{ENGINE_ROUNDS / (round_s + step_s):.3f} pairs/s, peak memory "
          f"{peak:.2f} GiB, personal models {gb:.3f} GB "
          f"({NUM_CLIENTS} x {N_PARAMS:,} f32), personal loss by step "
          f"{personal}, "
          f"launches a pair {pair}; evaluate_personal "
          f"{eval_s:.3f}s (K1 x2), personal accuracy "
          f"{ev['personal_accuracy']:.4f}, global {ev['global_accuracy']:.4f}"
          f" [{card}]", flush=True)

    ckpt = os.path.join(tmp, "ditto")
    t0 = time.perf_counter()
    save_engine_checkpoint(engine, os.path.join(ckpt, "engine"))
    save_ditto_checkpoint(ditto, os.path.join(ckpt, "personal"))
    save_s = time.perf_counter() - t0
    engine.run_round(evaluate=False)
    ditto.step()
    after = (_tree_clone(engine.global_variables),
             _tree_clone(ditto.personal_variables))
    t0 = time.perf_counter()
    restore_engine_checkpoint(engine, os.path.join(ckpt, "engine"))
    step = restore_ditto_checkpoint(ditto, os.path.join(ckpt, "personal"))
    restore_s = time.perf_counter() - t0
    engine.run_round(evaluate=False)
    ditto.step()
    require(_tree_equal(engine.global_variables, after[0])
            and _tree_equal(ditto.personal_variables, after[1]),
            "engines ditto: the pair after a restore differs from the "
            "uninterrupted one")
    del after
    print(f"engines ditto checkpoint: engine and {gb:.3f} GB of personal "
          f"models saved in {save_s:.2f}s, restored at step {step} in "
          f"{restore_s:.2f}s, the next (round, step) equal to the "
          f"uninterrupted one bit for bit [{card}]", flush=True)
    torch.cuda.empty_cache()
    return total, engine, ditto, reference


def engines_fedbuff(card, arrays, tmp):
    """FedBuff with a 64-client buffer and max_staleness 8: a warm-up
    step, FEDBUFF_STEPS timed ones (K1 = K2 = 10 a step), the staleness
    histogram and the cancellations, a checkpoint's next step bit for
    bit."""
    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.orchestration.checkpoint import (
        restore_async_checkpoint, save_async_checkpoint)

    steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
    engine = fedbuff_engine(arrays)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = engine.run_server_step()
    warm_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run(FEDBUFF_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # the rounds whose streams a buffer's rows draw, one draw each: a
    # completed client's attempt is its counter less the restart
    attempts = [len(set((engine._attempts[r.client_ids] - 1).tolist()))
                for r in results[-1:]]
    got, ok = _launched(conv_block_fwd=FEDBUFF_STEPS * steps,
                        conv_block_bwd=FEDBUFF_STEPS * steps)
    require(ok, f"engines fedbuff: launches {got}")
    total = dict(got)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [r.train_loss for r in [warm] + results]
    require(all(math.isfinite(v) for v in losses)
            and all(len(r.client_ids) == FEDBUFF_K
                    and max(r.staleness) <= FEDBUFF_STALENESS
                    for r in results), f"engines fedbuff: {results}")
    hist = np.bincount(np.concatenate([r.staleness for r in
                                       [warm] + results]),
                       minlength=FEDBUFF_STALENESS + 1)
    print(f"engines fedbuff buffer={FEDBUFF_K} max_staleness="
          f"{FEDBUFF_STALENESS}: {NUM_CLIENTS} clients bf16 'residual', "
          f"warm-up step {warm_s:.2f}s, {FEDBUFF_STEPS} server steps in "
          f"{dt:.3f}s -> {FEDBUFF_STEPS / dt:.3f} steps/s "
          f"({FEDBUFF_STEPS * FEDBUFF_K / dt:.1f} client updates/s), peak "
          f"memory {peak:.2f} GiB, staleness histogram {hist.tolist()}, "
          f"cancelled attempts {results[-1].cancelled_attempts}, sim time "
          f"{results[-1].sim_time:.3f}, {attempts[0]} distinct attempts "
          f"in the last buffer (one stream draw each), train loss "
          f"{[round(v, 4) for v in losses]}, launches a step K1 "
          f"{got['conv_block_fwd'] // FEDBUFF_STEPS} K2 "
          f"{got['conv_block_bwd'] // FEDBUFF_STEPS} [{card}]", flush=True)

    ckpt = os.path.join(tmp, "fedbuff")
    t0 = time.perf_counter()
    save_async_checkpoint(engine, ckpt)
    save_s = time.perf_counter() - t0
    a = engine.run_server_step()
    after = (_tree_clone(engine.global_variables), _tree_clone(engine.ring))
    t0 = time.perf_counter()
    step = restore_async_checkpoint(engine, ckpt)
    restore_s = time.perf_counter() - t0
    b = engine.run_server_step()
    require((a.client_ids, a.staleness, a.sim_time, a.cancelled_attempts)
            == (b.client_ids, b.staleness, b.sim_time, b.cancelled_attempts)
            and _tree_equal(engine.global_variables, after[0])
            and _tree_equal(engine.ring, after[1]),
            "engines fedbuff: the step after a restore differs from the "
            "uninterrupted one")
    print(f"engines fedbuff checkpoint: model, ring of "
          f"{FEDBUFF_STALENESS + 1} versions and the host event state saved "
          f"in {save_s:.3f}s, restored at server step {step} in "
          f"{restore_s:.3f}s, the next step equal to the uninterrupted one "
          f"bit for bit (timeline, model, ring) [{card}]", flush=True)
    del engine, after
    torch.cuda.empty_cache()
    return total


def engines_rank_job(mesh, global_after_round0, tmp):
    """One gloo rank's share (``phase_engines``): IFCA's first round; the
    bench engine's round with Ditto's step, the step from the unsharded
    run's global model; the engine's and the personal models' checkpoint
    at world 2. Returns the launches and what the main process compares."""
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.core.pytree import tree_map
    from fl_tpu_torch.fl import DittoPersonalizer
    from fl_tpu_torch.orchestration.checkpoint import (
        save_ditto_checkpoint, save_engine_checkpoint)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arrays = bench_arrays()
    lo, hi = mesh.client_rows(NUM_CLIENTS)
    out = {"rows": (lo, hi)}
    ifca = ifca_engine(arrays, mesh)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    r = ifca.run_round()
    torch.cuda.synchronize()
    out["ifca"] = {"s": time.perf_counter() - t0,
                   "launches": {k: v for k, v in ops.launch_counts().items()
                                if v},
                   "result": r, "assignments": ifca.assignments,
                   "models": tree_map(lambda t: t.cpu(),
                                      ifca.cluster_variables),
                   "collectives": [tuple(c) for c in ifca.round_collectives]}
    del ifca
    torch.cuda.empty_cache()

    engine = mesh_engine(mesh, arrays)
    ditto = DittoPersonalizer(engine, lam=DITTO_LAM)
    ops.reset_launch_counts()
    engine.run_round(evaluate=False)
    round0 = tree_map(lambda t: t.cpu(), engine.global_variables)
    # the step against the unsharded run's θ_g: the same inputs a client
    engine.global_variables = tree_map(lambda t: t.to(mesh.device),
                                       global_after_round0)
    t0 = time.perf_counter()
    m = ditto.step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    mine = [i for i in range(NUM_CLIENTS)[ENGINE_ROWS] if lo <= i < hi]
    save_engine_checkpoint(engine, os.path.join(tmp, "engine"))
    save_ditto_checkpoint(ditto, os.path.join(tmp, "personal"))
    out["ditto"] = {
        "launches": {k: v for k, v in ops.launch_counts().items() if v},
        "round0": round0, "metrics": m, "step_s": step_s,
        "rows": {i: tree_map(lambda t: t[i - lo].cpu(),
                             ditto.personal_variables) for i in mine},
        "digest": _rows_digest(ditto.personal_variables, slice(None)),
        "global_digest": _rows_digest(
            tree_map(lambda t: t[None], engine.global_variables), 0)}
    return out


def engines_mesh(card, ifca_ref, ditto_engine, ditto, ditto_ref, tmp):
    """IFCA's first round and the Ditto step on two gloo ranks sharing the
    card, held to the unsharded runs within phase_mesh's tolerances; the
    checkpoint saved at world 2 restored here, at world 1, bit for bit.
    Returns the ranks' launches."""
    import numpy as np
    import torch

    from fl_tpu_torch.core.mesh import spawn
    from fl_tpu_torch.core.pytree import tree_map
    from fl_tpu_torch.orchestration.checkpoint import (
        restore_ditto_checkpoint, restore_engine_checkpoint)

    ckpt = os.path.join(tmp, "mesh")
    g0, m0, rows0 = ditto_ref
    t0 = time.perf_counter()
    ranks = spawn(engines_rank_job, MESH_RANKS, tree_map(
        lambda t: t.cpu(), g0), ckpt, backend="gloo", device="cuda:0")
    spawn_s = time.perf_counter() - t0
    steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
    text, total = [], {}
    models, assign, warm = ifca_ref
    for r, got in enumerate(ranks):
        ifca = got["ifca"]
        want = {"conv_block_fwd": IFCA_K + steps, "conv_block_bwd": steps}
        require(ifca["launches"] == want,
                f"engines mesh rank {r} ifca: launches {ifca['launches']}")
        require([c[0] for c in ifca["collectives"]] == ["all_reduce"] * 2,
                f"engines mesh rank {r} ifca: collectives "
                f"{ifca['collectives']}")
        require(np.array_equal(ifca["assignments"], assign)
                and ifca["result"].cluster_sizes == warm.cluster_sizes,
                f"engines mesh rank {r} ifca: assignments differ")
        rel = abs(ifca["result"].train_loss - warm.train_loss) / abs(
            warm.train_loss)
        require(rel <= 1e-5, f"engines mesh rank {r} ifca: loss "
                             f"{ifca['result'].train_loss} against "
                             f"{warm.train_loss}")
        worst_ifca = _leaf_gaps(f"engines mesh rank {r} ifca",
                                ifca["models"], models)
        dit = got["ditto"]
        want = {"conv_block_fwd": 2 * steps, "conv_block_bwd": 2 * steps,
                "clip_noise": 2}
        require(dit["launches"] == want,
                f"engines mesh rank {r} ditto: launches {dit['launches']}")
        worst_round = _leaf_gaps(f"engines mesh rank {r} bench round",
                                 dit["round0"], g0)
        worst_rows = 0.0
        for i, row in dit["rows"].items():
            j = list(range(NUM_CLIENTS)[ENGINE_ROWS]).index(i)
            worst_rows = max(worst_rows, _leaf_gaps(
                f"engines mesh rank {r} ditto client {i}", row,
                tree_map(lambda t: t[j], rows0)))
        rel_d = {k: abs(dit["metrics"][k] - m0[k]) / max(abs(m0[k]), 1e-30)
                 for k in m0}
        require(all(v <= 1e-4 for v in rel_d.values()),
                f"engines mesh rank {r} ditto: step metrics {dit['metrics']}"
                f" against {m0}")
        for src in (ifca["launches"], dit["launches"]):
            for k, v in src.items():
                total[k] = total.get(k, 0) + v
        text.append(
            f"rank {r}: ifca round {ifca['s']:.3f}s, collectives "
            f"{ifca['collectives']}, max |w - w_unsharded| "
            f"{worst_ifca:.2e}; bench round max gap {worst_round:.2e}; "
            f"ditto step {dit['step_s']:.3f}s, {len(dit['rows'])} clients' "
            f"personal models max gap {worst_rows:.2e}, metrics' rel. gaps "
            f"{ {k: f'{v:.1e}' for k, v in rel_d.items()} }")

    # world 2 -> world 1: the engine's and the personal models' files
    t0 = time.perf_counter()
    restore_engine_checkpoint(ditto_engine, os.path.join(ckpt, "engine"))
    restore_ditto_checkpoint(ditto, os.path.join(ckpt, "personal"))
    restore_s = time.perf_counter() - t0
    require(_rows_digest(tree_map(lambda t: t[None],
                                  ditto_engine.global_variables), 0)
            == ranks[0]["ditto"]["global_digest"],
            "engines mesh: the global model restored at world 1 differs "
            "from the one saved at world 2")
    for r, got in enumerate(ranks):
        lo, hi = got["rows"]
        require(_rows_digest(ditto.personal_variables, slice(lo, hi))
                == got["ditto"]["digest"],
                f"engines mesh: rank {r}'s personal models restored at "
                "world 1 differ from the ones it saved at world 2")
    print(f"engines mesh gloo world_size={MESH_RANKS} on one card (spawn "
          f"and both ranks {spawn_s:.1f}s): " + "; ".join(text)
          + f"; checkpoint saved at world 2 restored at world 1 in "
          f"{restore_s:.2f}s, the global model and every rank's personal "
          f"rows equal bit for bit (sha256) [{card}]", flush=True)
    return total


def engines_learning(card):
    """Label-permuted halves (clients 8-15: y + 5 mod 10) of 16 clients x
    256 synthetic MNIST images, bf16 ``"residual"``, no DP: IFCA with
    warm starts reaches perfect population purity, Ditto's personal
    models beat the global one on their own shards; FedBuff on the
    unpermuted clients raises the test accuracy."""
    import torch

    from fl_tpu_torch.data import load_dataset, make_federated_arrays
    from fl_tpu_torch.fl import (AsyncConfig, AsyncFederatedEngine,
                                 DittoPersonalizer)
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    C = 16
    splits = load_dataset("mnist", n_train_synth=C * 256, n_test_synth=1024)

    def arrays(permuted):
        fa = make_federated_arrays(splits, C, "iid", samples_per_client=256,
                                   seed=0)
        if permuted:
            fa.labels[C // 2:] = (fa.labels[C // 2:] + 5) % 10
        return fa

    train = FederatedTrainingConfig(local_epochs=2, batch_size=32,
                                    learning_rate=1e-3)
    ifca = ifca_engine(arrays(True), num_clusters=2,
                       warmstart_clients=(0, C - 1), training=train)
    sizes = [r.cluster_sizes for r in ifca.run(4)]
    a = ifca.assignments
    require(len(set(a[:C // 2])) == 1 and len(set(a[C // 2:])) == 1
            and a[0] != a[-1],
            f"learning ifca: assignments {a.tolist()}, sizes {sizes}")
    del ifca

    engine = FederatedRoundEngine(
        bench_model("residual"), arrays(True),
        RoundEngineConfig(training=train, max_clients=C, seed=0),
        device=DEVICE)
    ditto = DittoPersonalizer(engine, lam=DITTO_LAM)
    for _ in range(3):
        engine.run_round(evaluate=False)
        ditto.step()
    ev = ditto.evaluate_personal()
    require(ev["personalization_gain"] > 0, f"learning ditto: {ev}")
    del engine, ditto

    fb = AsyncFederatedEngine(
        bench_model("residual"), arrays(False),
        AsyncConfig(training=train, buffer_size=4, seed=0), device=DEVICE)
    before = fb.evaluate(splits.test_images, splits.test_labels)["accuracy"]
    fb.run(8)
    after = fb.evaluate(splits.test_images, splits.test_labels)["accuracy"]
    require(after > before, f"learning fedbuff: test accuracy {before} -> "
                            f"{after}")
    del fb
    torch.cuda.empty_cache()
    print(f"learning engines: 16 clients, label-permuted halves; ifca k=2 "
          f"warm-started: pure populations, sizes by round {sizes}; ditto "
          f"lam={DITTO_LAM} after 3 (round, step): personal accuracy "
          f"{ev['personal_accuracy']:.4f} against global "
          f"{ev['global_accuracy']:.4f} (gain "
          f"{ev['personalization_gain']:.4f}); fedbuff buffer 4 (unpermuted"
          f" labels), 8 server steps: test accuracy {before:.4f} -> "
          f"{after:.4f} [{card}]", flush=True)


def phase_engines(card, counts):
    """The clustered (IFCA), Ditto and async (FedBuff) engines at the
    bench's full width (512 clients x 64 synthetic MNIST images, SimpleCNN
    bf16 ``"residual"``, Adam with bf16 moments, 5 epochs x batch 32):
    each one's rounds, launches and memory, a checkpoint's next round bit
    for bit, IFCA and the Ditto step on two gloo ranks, the learning
    checks. Its launches join ``counts``."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    arrays = bench_arrays()
    with tempfile.TemporaryDirectory(prefix="fl_engines_") as tmp:
        launches = []
        got, ifca_ref = engines_ifca(card, arrays, tmp)
        launches.append(got)
        launches.append(engines_fedbuff(card, arrays, tmp))
        # the Ditto engine stays resident for the 2-rank comparison
        got, engine, ditto, ditto_ref = engines_ditto(card, tmp)
        launches.append(got)
        launches.append(engines_mesh(card, ifca_ref, engine, ditto,
                                     ditto_ref, tmp))
        del engine, ditto, ifca_ref, ditto_ref
        torch.cuda.empty_cache()
    engines_learning(card)
    for got in launches:
        for k in ("conv_block_fwd", "conv_block_bwd", "clip_noise"):
            counts[k] = counts.get(k, 0) + got.get(k, 0)
    print(f"engines: phase {time.perf_counter() - t_phase:.1f}s [{card}]",
          flush=True)


# ---------------------------------------------------------------------------
# the hierarchical, decentralized, FedDF and HPO engines (phase_topologies)
# ---------------------------------------------------------------------------

TOPO_EDGES = 8           # HierFAVG's edges
TOPO_TAU = 2             # cloud sync every 2 rounds
TOPO_HIER_ROUNDS = 3     # timed rounds after a warm-up (4 in all)
TOPO_DEC_ROUNDS = 2      # timed ring rounds after a warm-up (3 in all)
FEDDF_PROXY = 2048       # synthetic uint8 proxy images
FEDDF_STEPS = 64         # the reference's defaults: 64 steps x 256
FEDDF_BATCH = 256
FEDDF_MESH_STEPS = 8     # the 2-rank comparison's SGD distill steps
HPO_LRS = (1e-4, 1e-3, 1e-2)
HPO_ROUNDS = 2           # timed rounds after the warm-up rung round
HPO_VAL = 1024           # validation images
K1_CHUNK = 64            # clients a plain-version chunk at (512, 256)


def _steps():
    return LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)


def hier_engine(arrays, mesh=None):
    from fl_tpu_torch.fl import (HierarchicalConfig,
                                 HierarchicalFederatedEngine)

    return HierarchicalFederatedEngine(
        bench_model("residual"), arrays,
        HierarchicalConfig(training=bench_training(), num_edges=TOPO_EDGES,
                           global_sync_every=TOPO_TAU, seed=0),
        mesh=mesh, device=None if mesh is not None else DEVICE)


def dec_engine(arrays, mesh=None, mixing=None):
    from fl_tpu_torch.fl import (DecentralizedConfig,
                                 DecentralizedFederatedEngine)

    return DecentralizedFederatedEngine(
        bench_model("residual"), arrays,
        DecentralizedConfig(training=bench_training(), mixing_matrix=mixing,
                            seed=0),
        mesh=mesh, device=None if mesh is not None else DEVICE)


def feddf_proxy():
    from fl_tpu_torch.data import load_dataset

    return load_dataset("mnist", n_train_synth=FEDDF_PROXY, n_test_synth=1,
                        seed=7).train_images


def feddf_engine(arrays, proxy, mesh=None, **cfg):
    """FedDF at the reference's defaults unless ``cfg`` says otherwise."""
    from fl_tpu_torch.fl import FedDFConfig, FedDFEngine

    cfg.setdefault("distill_steps", FEDDF_STEPS)
    return FedDFEngine(
        bench_model("residual"), arrays, proxy,
        FedDFConfig(training=bench_training(), distill_batch=FEDDF_BATCH,
                    seed=0, **cfg),
        mesh=mesh, device=None if mesh is not None else DEVICE)


def hpo_val():
    from fl_tpu_torch.data import load_dataset

    splits = load_dataset("mnist", n_train_synth=1, n_test_synth=HPO_VAL,
                          seed=9)
    return splits.test_images, splits.test_labels


def hpo_engine(arrays, mesh=None):
    from fl_tpu_torch.fl import FederatedHPOEngine, HPOConfig

    vx, vy = hpo_val()
    return FederatedHPOEngine(
        bench_model("residual"), arrays,
        HPOConfig(training=bench_training(), learning_rates=HPO_LRS,
                  rung_rounds=(0,), eta=2, seed=0), vx, vy,
        mesh=mesh, device=None if mesh is not None else DEVICE)


def _timed_rounds(engine, rounds, run=None):
    """``rounds`` rounds after the reset of the launch counts and of the
    peak memory: (results, seconds, launches, peak GiB)."""
    import torch

    from fl_tpu_torch import ops

    run = run or engine.run_round
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = [run() for _ in range(rounds)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (results, dt, ops.launch_counts(),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def topo_hierarchical(card, arrays):
    """HierFAVG at E = 8, τ = 2: a warm-up round and TOPO_HIER_ROUNDS
    timed ones (K1 = K2 = 10 a round), the edge divergence 0.0 after each
    sync and positive between. Returns (launches, the warm-up round's edge
    models and result: the 2-rank run's reference)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    eng = hier_engine(arrays)
    t0 = time.perf_counter()
    warm = eng.run_round()
    warm_s = time.perf_counter() - t0
    ref = (_tree_clone(eng.edge_variables), warm)
    results, dt, got, peak = _timed_rounds(eng, TOPO_HIER_ROUNDS)
    _, ok = _launched(conv_block_fwd=TOPO_HIER_ROUNDS * _steps(),
                      conv_block_bwd=TOPO_HIER_ROUNDS * _steps())
    require(ok, f"topologies hierarchical: launches {got}")
    rs = [warm] + results
    require([r.cloud_synced for r in rs]
            == [(i + 1) % TOPO_TAU == 0 for i in range(len(rs))]
            and all((r.edge_divergence == 0.0) == r.cloud_synced
                    for r in rs)
            and all(math.isfinite(r.train_loss) for r in rs),
            f"topologies hierarchical: {rs}")
    print(f"topologies hierarchical E={TOPO_EDGES} tau={TOPO_TAU}: "
          f"{NUM_CLIENTS} clients bf16 'residual', warm-up round "
          f"{warm_s:.2f}s, {TOPO_HIER_ROUNDS} rounds in {dt:.3f}s -> "
          f"{TOPO_HIER_ROUNDS / dt:.3f} rounds/s, peak memory {peak:.2f} "
          f"GiB, synced {[r.cloud_synced for r in rs]}, edge divergence "
          f"{[float(f'{r.edge_divergence:.4g}') for r in rs]} (0.0 after "
          f"each sync), train loss {[round(r.train_loss, 4) for r in rs]}, "
          f"launches a round K1 {got['conv_block_fwd'] // TOPO_HIER_ROUNDS} "
          f"K2 {got['conv_block_bwd'] // TOPO_HIER_ROUNDS} [{card}]",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    return dict(got), ref


def topo_decentralized(card, arrays):
    """D-PSGD on the ring: a warm-up round and TOPO_DEC_ROUNDS timed ones
    (K1 = K2 = 10 a round); then one round at W = 11ᵀ/C held to one
    no-DP round of FederatedRoundEngine from the same init, every client
    within 1e-5 of each leaf's largest weight. Returns (launches, the
    warm-up round's sampled client rows, mean model and result)."""
    import numpy as np
    import torch

    from fl_tpu_torch.core.pytree import flatten_dict, tree_map
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)

    torch.cuda.reset_peak_memory_stats()
    eng = dec_engine(arrays)
    t0 = time.perf_counter()
    warm = eng.run_round()
    warm_s = time.perf_counter() - t0
    ref = (tree_map(lambda t: t[ENGINE_ROWS].clone(), eng.client_variables),
           eng.mean_model(), warm)
    results, dt, got, peak = _timed_rounds(eng, TOPO_DEC_ROUNDS)
    _, ok = _launched(conv_block_fwd=TOPO_DEC_ROUNDS * _steps(),
                      conv_block_bwd=TOPO_DEC_ROUNDS * _steps())
    require(ok, f"topologies decentralized: launches {got}")
    rs = [warm] + results
    require(all(math.isfinite(r.train_loss)
                and math.isfinite(r.consensus_distance) for r in rs),
            f"topologies decentralized: {rs}")
    del eng
    torch.cuda.empty_cache()

    # the complete uniform graph is FedAvg: one round of each engine
    C = NUM_CLIENTS
    full = dec_engine(arrays, mixing=np.full((C, C), 1.0 / C))
    flat = FederatedRoundEngine(
        bench_model("residual"), arrays,
        RoundEngineConfig(training=bench_training(), max_clients=C, seed=0),
        device=DEVICE)
    r_full = full.run_round()
    flat.run_round(mask=np.ones(C, np.float32), evaluate=False)
    # every client row at once: each leaf's largest gap over the clients
    g = flatten_dict(flat.global_variables)
    worst = 0.0
    for k, v in flatten_dict(full.client_variables).items():
        gap = float((v.float() - g[k].float()[None]).abs().max())
        top = float(g[k].float().abs().max())
        require(gap <= 1e-6 + 1e-5 * top,
                f"topologies decentralized complete graph: {k} off by {gap} "
                f"(its largest weight {top})")
        worst = max(worst, gap)
    require(r_full.consensus_distance < 1e-3,
            f"topologies decentralized complete graph: consensus "
            f"{r_full.consensus_distance}")
    print(f"topologies decentralized ring: {NUM_CLIENTS} client models bf16 "
          f"'residual', warm-up round {warm_s:.2f}s, {TOPO_DEC_ROUNDS} rounds "
          f"in {dt:.3f}s -> {TOPO_DEC_ROUNDS / dt:.3f} rounds/s, peak memory "
          f"{peak:.2f} GiB, consensus distance "
          f"{[float(f'{r.consensus_distance:.5g}') for r in rs]}, train loss "
          f"{[round(r.train_loss, 4) for r in rs]}, launches a round K1 "
          f"{got['conv_block_fwd'] // TOPO_DEC_ROUNDS} K2 "
          f"{got['conv_block_bwd'] // TOPO_DEC_ROUNDS}; W = 11^T/C: every "
          f"client's model within 1e-5 of each leaf's largest weight of the "
          f"round engine's no-DP round from the same init (max gap "
          f"{worst:.2e}), consensus {r_full.consensus_distance:.3g} "
          f"[{card}]", flush=True)
    del full, flat
    torch.cuda.empty_cache()
    return dict(got), ref


def topo_feddf(card, arrays, proxy):
    """FedDF at the reference's defaults (64 Adam steps x 256 proxy
    images, τ = 1): a warm-up round and one timed (K1 = 10 training + 65
    teacher forwards at (512, 256) + 64 student forwards and 2 probes at
    (1, 256); K2 = 10 + 64), the probe KL shrinking in both. Returns the
    launches."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    eng = feddf_engine(arrays, proxy)
    t0 = time.perf_counter()
    warm = eng.run_round()
    warm_s = time.perf_counter() - t0
    results, dt, got, peak = _timed_rounds(eng, 1)
    want_k1 = _steps() + (1 + FEDDF_STEPS) + FEDDF_STEPS + 2
    want_k2 = _steps() + FEDDF_STEPS
    _, ok = _launched(conv_block_fwd=want_k1, conv_block_bwd=want_k2)
    require(ok, f"topologies feddf: launches {got}")
    rs = [warm] + results
    require(all(math.isfinite(r.train_loss)
                and r.distill_kl_after < r.distill_kl_before for r in rs),
            f"topologies feddf: the probe KL did not shrink: {rs}")
    kls = [(round(r.distill_kl_before, 5), round(r.distill_kl_after, 5))
           for r in rs]
    print(f"topologies feddf {FEDDF_STEPS} adam steps x {FEDDF_BATCH} of "
          f"{FEDDF_PROXY} proxy images: {NUM_CLIENTS} clients bf16 "
          f"'residual', warm-up round {warm_s:.2f}s, 1 round in {dt:.3f}s "
          f"-> {1 / dt:.3f} rounds/s, peak memory {peak:.2f} GiB, probe KL "
          f"before -> after {kls}, "
          f"train loss {[round(r.train_loss, 4) for r in rs]}, launches a "
          f"round K1 {got['conv_block_fwd']} (10 training + "
          f"{1 + FEDDF_STEPS} teacher at ({NUM_CLIENTS}, {FEDDF_BATCH}) + "
          f"{FEDDF_STEPS + 2} student at (1, {FEDDF_BATCH})) K2 "
          f"{got['conv_block_bwd']} [{card}]", flush=True)
    del eng
    torch.cuda.empty_cache()
    return dict(got)


def topo_hpo(card, arrays):
    """HPO over learning rates HPO_LRS, a rung after round 0 (η = 2): the
    warm-up rung round at G = 3 (1,536 trainer rows) kills one trial, the
    survivors' models equal to their slots before the compaction bit for
    bit; then HPO_ROUNDS timed rounds at G = 2 (K1 = 10 + 1 validation
    forward, K2 = 10 a round). Returns (launches, the warm-up round's
    trial models and result)."""
    import torch

    from fl_tpu_torch.core.pytree import tree_map

    torch.cuda.reset_peak_memory_stats()
    eng = hpo_engine(arrays)
    pre = []
    score = eng._val_accuracies

    def snapshot():
        pre.append(_tree_clone(eng.trial_variables))
        return score()

    eng._val_accuracies = snapshot
    t0 = time.perf_counter()
    warm = eng.run_round()
    warm_s = time.perf_counter() - t0
    peak0 = torch.cuda.max_memory_allocated() / 2 ** 30
    eng._val_accuracies = score
    kept = list(eng._alive_ids)
    require(warm.halved and len(kept) == 2,
            f"topologies hpo: rung round {warm}")
    require(_tree_equal(eng.trial_variables, tree_map(
        lambda t: t[torch.as_tensor(kept, device=t.device)], pre[0])),
            "topologies hpo: the survivors' models differ from their slots "
            "before the compaction")
    ref = (_tree_clone(eng.trial_variables), warm)
    del pre
    torch.cuda.reset_peak_memory_stats()
    results, dt, got, peak = _timed_rounds(eng, HPO_ROUNDS)
    _, ok = _launched(conv_block_fwd=HPO_ROUNDS * (_steps() + 1),
                      conv_block_bwd=HPO_ROUNDS * _steps())
    require(ok, f"topologies hpo: launches {got}")
    dead = [t.trial_id for t in eng.trials if not t.alive]
    print(f"topologies hpo lrs={HPO_LRS} rung after round 0 eta=2: "
          f"{NUM_CLIENTS} clients bf16 'residual', rung round at G=3 "
          f"({3 * NUM_CLIENTS} trainer rows) {warm_s:.2f}s with peak memory "
          f"{peak0:.2f} GiB, killed trial {dead}, survivors bit for bit "
          f"their pre-compaction slots; {HPO_ROUNDS} rounds at G=2 in "
          f"{dt:.3f}s -> {HPO_ROUNDS / dt:.3f} rounds/s, peak memory "
          f"{peak:.2f} GiB, validation accuracy by round "
          f"{[r.val_accuracies for r in [warm] + results]}, best trial "
          f"{eng.best_trial().trial_id}, launches a round K1 "
          f"{got['conv_block_fwd'] // HPO_ROUNDS} K2 "
          f"{got['conv_block_bwd'] // HPO_ROUNDS} [{card}]", flush=True)
    del eng
    torch.cuda.empty_cache()
    return dict(got), ref


def topo_kernel_shapes(card, report):
    """K1 at FedDF's teacher shape (512, 256) and student shape (1, 256),
    K2 at (1, 256), bf16, held to their plain versions (the plain forward
    at (512, 256) in chunks of K1_CHUNK clients); their errors join the
    kernel report's."""
    import torch

    from fl_tpu_torch.ops import conv_block as cb

    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    dt = torch.bfloat16
    text, err = [], {"conv_block_fwd": 0.0, "conv_block_bwd": 0.0}
    for C in (NUM_CLIENTS, 1):
        B = FEDDF_BATCH
        tag = f"bf16 C={C} B={B}"
        args = conv_inputs(gen, C, B, dt)
        pooled, idx = cb.conv_block_fwd_cuda(*args)
        k1_ms = time_ms(lambda: cb.conv_block_fwd_cuda(*args))
        for c0 in range(0, C, K1_CHUNK):
            part = [a[c0:c0 + K1_CHUNK] for a in args]
            p_ref, i_ref = cb.conv_stack_res_fwd_plain(*part)
            err["conv_block_fwd"] = max(err["conv_block_fwd"], check_pooled(
                "K1", tag, pooled[c0:c0 + K1_CHUNK], p_ref, dt))
            check_index("K1", tag, cb, part, idx[c0:c0 + K1_CHUNK], i_ref,
                        p_ref)
        fwd_bound = conv_work(args, torch.zeros_like(pooled))[0][
            "conv_block_fwd"][0]
        line = f"K1 ({C}, {B}) {k1_ms:.3f} ms (bound {fwd_bound:.3f})"
        if C == 1:
            x, w1, b1, w2, _ = args
            g = (torch.randn(pooled.shape, generator=gen, device="cuda")
                 * (p_ref > 0)).to(dt).contiguous()
            got = cb.conv_block_bwd_cuda(g, i_ref, x, w1, b1, w2)
            want = cb.conv_stack_res_bwd_plain(g, i_ref, x, w1, b1, w2)
            err["conv_block_bwd"] = check_grads("K2", tag, got, want, dt)
            k2_ms = time_ms(lambda: cb.conv_block_bwd_cuda(g, i_ref, x, w1,
                                                           b1, w2))
            plain_ms = time_ms(lambda: cb.conv_stack_res_bwd_plain(
                g, i_ref, x, w1, b1, w2))
            bwd_bound = conv_work(args, g)[0]["conv_block_bwd"][0]
            fwd_plain_ms = time_ms(lambda: cb.conv_stack_res_fwd_plain(*args))
            line += (f", plain {fwd_plain_ms:.3f}; "
                     f"K2 ({C}, {B}) {k2_ms:.3f} ms, plain {plain_ms:.3f} "
                     f"(bound {bwd_bound:.3f})")
        text.append(line)
        del args, pooled, idx
        torch.cuda.empty_cache()
    for k, v in err.items():
        report[k]["max_abs_err"] = max(report[k].get("max_abs_err", 0.0), v)
    print(f"topologies kernels: K1 at ({NUM_CLIENTS}, {FEDDF_BATCH}) and "
          f"(1, {FEDDF_BATCH}), K2 at (1, {FEDDF_BATCH}), bf16, match their "
          f"plain versions (1 bf16 ulp / 1e-2 relative Frobenius; max abs "
          f"err K1 {err['conv_block_fwd']:.3g}, K2 "
          f"{err['conv_block_bwd']:.3g}): " + "; ".join(text)
          + f" [{card}]", flush=True)


def topo_rank_job(mesh, proxy):
    """One gloo rank's share (``phase_topologies``): each engine's first
    round. Returns per engine the launches, the round's collectives and
    what the main process compares."""
    import torch

    from fl_tpu_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arrays = bench_arrays()
    lo, hi = mesh.client_rows(NUM_CLIENTS)
    out = {"rows": (lo, hi)}
    host = host_tree

    def first_round(name, eng, keep):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = eng.run_round()
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0, "result": r,
                     "launches": {k: v for k, v in
                                  ops.launch_counts().items() if v},
                     "collectives": [tuple(c) for c in
                                     eng.round_collectives],
                     **keep(eng)}
        del eng
        torch.cuda.empty_cache()

    first_round("hierarchical", hier_engine(arrays, mesh),
                lambda e: {"models": host(e.edge_variables)})
    mine = [i for i in range(NUM_CLIENTS)[ENGINE_ROWS] if lo <= i < hi]
    first_round("decentralized", dec_engine(arrays, mesh),
                lambda e: {"rows": {i: host(e.client_model(i))
                                    for i in mine},
                           "models": host(e.mean_model())})
    first_round("feddf", feddf_engine(
        arrays, proxy, mesh, distill_steps=FEDDF_MESH_STEPS,
        distill_optimizer="sgd"),
        lambda e: {"models": host(e.global_variables)})
    first_round("hpo", hpo_engine(arrays, mesh),
                lambda e: {"models": host(e.trial_variables)})
    return out


def topo_mesh(card, arrays, proxy, refs):
    """Each engine's first round on two gloo ranks sharing the card, held
    to the single-process first round within 1e-5 of each leaf's largest
    weight (FedDF with SGD distillation, its own single-process round
    here: Adam turns the teacher sum's reduction order into lr-sized steps
    where a gradient is near zero). Returns the ranks' launches."""
    import torch

    from fl_tpu_torch.core.mesh import spawn
    from fl_tpu_torch.core.pytree import tree_map

    eng = feddf_engine(arrays, proxy, distill_steps=FEDDF_MESH_STEPS,
                       distill_optimizer="sgd")
    r_df = eng.run_round()
    refs["feddf"] = (host_tree(eng.global_variables), r_df)
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(topo_rank_job, MESH_RANKS, proxy, backend="gloo",
                  device="cuda:0")
    spawn_s = time.perf_counter() - t0
    steps = _steps()
    want_launches = {
        "hierarchical": (steps, steps), "decentralized": (steps, steps),
        "feddf": (steps + 1 + 2 * FEDDF_MESH_STEPS + 2,
                  steps + FEDDF_MESH_STEPS),
        "hpo": (steps + 1, steps)}
    total, text = {}, []
    for r, got in enumerate(ranks):
        lo, hi = got["rows"]
        parts = []
        for name, (k1, k2) in want_launches.items():
            g, label = got[name], f"topologies mesh rank {r} {name}"
            require(g["launches"] == {"conv_block_fwd": k1,
                                      "conv_block_bwd": k2},
                    f"{label}: launches {g['launches']}")
            for k, v in g["launches"].items():
                total[k] = total.get(k, 0) + v
            res, want = g["result"], refs[name][-1]
            if name == "decentralized":
                rows0, mean0 = refs[name][0], refs[name][1]
                sampled = list(range(NUM_CLIENTS)[ENGINE_ROWS])
                worst = _leaf_gaps(f"{label} mean model", g["models"],
                                   mean0)
                for i, row in g["rows"].items():
                    worst = max(worst, _leaf_gaps(
                        f"{label} client {i}", row, tree_map(
                            lambda t: t[sampled.index(i)], rows0)))
                require(abs(res.consensus_distance
                            - want.consensus_distance)
                        <= 1e-4 * want.consensus_distance,
                        f"{label}: consensus {res.consensus_distance} "
                        f"against {want.consensus_distance}")
            else:
                worst = _leaf_gaps(label, g["models"], refs[name][0])
            if name == "hpo":
                require(res.alive_trials == want.alive_trials
                        and res.val_accuracies.keys()
                        == want.val_accuracies.keys()
                        and all(abs(res.val_accuracies[t]
                                    - want.val_accuracies[t])
                                <= 2.0 / HPO_VAL
                                for t in want.val_accuracies),
                        f"{label}: {res} against {want}")
            else:
                require(abs(res.train_loss - want.train_loss)
                        <= 1e-4 * abs(want.train_loss),
                        f"{label}: loss {res.train_loss} against "
                        f"{want.train_loss}")
            parts.append(f"{name} {g['s']:.3f}s, max gap {worst:.2e}, "
                         f"collectives {g['collectives']}")
        text.append(f"rank {r} (clients {lo}-{hi - 1}): " + "; ".join(parts))
    print(f"topologies mesh gloo world_size={MESH_RANKS} on one card (spawn "
          f"and both ranks {spawn_s:.1f}s): each engine's first round "
          f"within 1e-5 of each leaf's largest weight of the single-process "
          f"round (feddf with {FEDDF_MESH_STEPS} SGD steps): "
          + " | ".join(text) + f" [{card}]", flush=True)
    return total


def phase_topologies(card, counts, report):
    """The hierarchical (HierFAVG), decentralized (D-PSGD), FedDF and
    federated-HPO engines at the bench's full width (512 clients x 64
    synthetic MNIST images, SimpleCNN bf16 ``"residual"``, Adam with bf16
    moments, 5 epochs x batch 32): each one's rounds/s, peak memory and
    launches a round; K1 and K2 at FedDF's new shapes against their plain
    versions; each engine's first round on two gloo ranks. Its launches
    join ``counts``."""
    import torch

    t_phase = time.perf_counter()
    arrays = bench_arrays()
    proxy = feddf_proxy()
    topo_kernel_shapes(card, report)
    launches, refs = [], {}
    got, (models, res) = topo_hierarchical(card, arrays)
    launches.append(got)
    refs["hierarchical"] = (host_tree(models), res)
    got, (rows, mean, res) = topo_decentralized(card, arrays)
    launches.append(got)
    refs["decentralized"] = (host_tree(rows), host_tree(mean), res)
    launches.append(topo_feddf(card, arrays, proxy))
    got, (models, res) = topo_hpo(card, arrays)
    launches.append(got)
    refs["hpo"] = (host_tree(models), res)
    del models, rows, mean
    torch.cuda.empty_cache()
    launches.append(topo_mesh(card, arrays, proxy, refs))
    for got in launches:
        for k in ("conv_block_fwd", "conv_block_bwd"):
            counts[k] = counts.get(k, 0) + got.get(k, 0)
    print(f"topologies: phase {time.perf_counter() - t_phase:.1f}s [{card}]",
          flush=True)


# ---------------------------------------------------------------------------
# the simulation entry point, the validation harness, vertical FL and
# federated analytics
# ---------------------------------------------------------------------------

VAL_SIM = (5, 10)           # the README's quick start: clients, rounds
VAL_CLI_ROUNDS = 1          # the command line's rounds (cut from 10: the
                            # same code as the in-process run, 6.6-8.4 s a
                            # round)
VAL_K3_SHAPE = (4, 65_536)  # PrivacyValidator's noise test
VAL_INV_STEPS = 300         # the inversion attack's Adam steps (2 restarts)
VAL_HIST = (4096, 16_384)   # dp_histogram: clients x buckets
VAL_PARTIES = 4             # vertical FL over the 20,000-row synthetic MNIST


def _k3_since(label, want):
    """K3's launches since the last reset, required equal to ``want``;
    no other kernel may have launched."""
    got, ok = _launched(clip_noise=want)
    require(ok, f"{label}: launches {got}, expected clip_noise={want} and "
            "nothing else")
    return want


def validation_k3_check(card):
    """K3 through ``clip_noise_matrix`` at the validator's (4, 65,536)
    shape against ``clip_noise_plain``, row i scaled by 10^i so that rows
    1-3 lie above the clip norm (row norms about 0.26, 2.6, 26, 256
    against 1.0): exact at σ = 0 (ε = inf), and its noise at ε = 1 by
    moments. Comparison launches: not counted."""
    import torch

    from fl_tpu_torch.ops import dp as dp_ops

    g = torch.Generator(device=DEVICE).manual_seed(19)
    x = torch.randn(VAL_K3_SHAPE, device=DEVICE, generator=g) * 0.001
    x *= 10.0 ** torch.arange(VAL_K3_SHAPE[0], device=DEVICE)[:, None]
    norms = x.square().sum(1).sqrt()
    clipped = x * torch.clamp(1.0 / norms, max=1.0)[:, None]
    seeds = [101, 102, 103, 104]
    got, sens, sig = dp_ops.clip_noise_matrix(x, seeds, math.inf, 1e-5, 1.0)
    want, wsens, wsig = dp_ops.clip_noise_matrix(x, seeds, math.inf, 1e-5,
                                                 1.0, use_pallas=False)
    n_clip = int((norms > 1.0).sum())
    require(n_clip == 3 and torch.equal(got, want)
            and torch.equal(sens, wsens)
            and float(sig.abs().max()) == 0.0
            and float((got - clipped).abs().max()) < 1e-6,
            f"validation K3: clip_noise_matrix at sigma 0 differs from "
            f"clip_noise_plain ({n_clip} rows above the clip norm, max "
            f"|got - clipped| {float((got - clipped).abs().max())})")
    noisy, sens, sig = dp_ops.clip_noise_matrix(x, seeds, 1.0, 1e-5, 1.0)
    resid = noisy - clipped
    ratio = (resid.std(1) / sig).cpu()
    mean = (resid.mean(1) / sig).cpu()
    kurt = ((resid / sig[:, None]) ** 4).mean(1).cpu()
    require(bool(((ratio - 1).abs() < 0.02).all())
            and bool((mean.abs() < 5 / 256).all())
            and bool(((kurt - 3).abs() < 0.1).all()),
            f"validation K3: noise std/sigma {ratio.tolist()}, mean/sigma "
            f"{mean.tolist()}, kurtosis {kurt.tolist()}")
    plain = dp_ops.clip_noise_matrix(x, seeds, 1.0, 1e-5, 1.0,
                                     use_pallas=False)[0]
    ms = time_ms(lambda: dp_ops.clip_noise_matrix(x, seeds, 1.0, 1e-5, 1.0))
    plain_ms = time_ms(lambda: dp_ops.clip_noise_matrix(
        x, seeds, 1.0, 1e-5, 1.0, use_pallas=False))
    print(f"validation K3 clip_noise_matrix {VAL_K3_SHAPE}, {n_clip} of "
          f"{VAL_K3_SHAPE[0]} rows above the clip norm: sigma=0 equal to "
          f"clip_noise_plain bit for bit; at eps=1 noise std/sigma "
          f"{min(ratio.tolist()):.4f}..{max(ratio.tolist()):.4f}, kurtosis "
          f"{min(kurt.tolist()):.3f}..{max(kurt.tolist()):.3f} (plain "
          f"version's std/sigma "
          f"{float(((plain - clipped).std(1) / sig).mean()):.4f}); "
          f"{ms:.3f} ms (plain {plain_ms:.3f} ms) [{card}]", flush=True)


def validation_simulation(card):
    """``run_mnist_simulation(5, 10)`` (the quick start: delta DP at
    epsilon 1 over 10 rounds, non-IID, heterogeneous epoch budgets) and the
    command line in a subprocess, with its onchip backend and, where
    ``grpcio`` imports, its grpc backend (else its refusal naming
    ``grpcio``). Returns K3's launches."""
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.orchestration.simulation import run_mnist_simulation

    clients, rounds = VAL_SIM
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_mnist_simulation(clients, rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist = res["round_history"]
    # 2 leaf groups a delta-DP round: fc1's kernel alone, the rest together
    k3 = _k3_since("validation simulation", 2 * len(hist))
    require(res["rounds_completed"] == rounds
            and res["stop_reason"] == "round_budget_exhausted"
            and all(math.isfinite(h["train_loss"]) for h in hist)
            and abs(res["total_epsilon_spent"] - 1.0) < 1e-9,
            f"validation simulation: {res['rounds_completed']} rounds, "
            f"{res['stop_reason']}, eps {res['total_epsilon_spent']}")
    # the collector's rounds run from start_round to complete_round: the
    # round with its evaluation, on the host's clock
    wall_round = res["training_progress"]["avg_round_duration_s"]
    print(f"validation run_mnist_simulation({clients}, {rounds}): "
          f"rounds/s {res['rounds_per_sec']:.3f} (the results' formula, "
          f"rounds over the sum of round_time_s), wall clock "
          f"{1 / wall_round:.3f} rounds/s (each round with its evaluation; "
          f"the call {wall:.2f}s with data and build); final "
          f"accuracy {res['final_accuracy']:.4f} (best "
          f"{res['best_accuracy']:.4f}), eps spent "
          f"{res['total_epsilon_spent']:.3f} of "
          f"{res['privacy_budget']['initial_epsilon']}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; K3 "
          f"launches {k3} [{card}]", flush=True)

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "fl_tpu_torch.orchestration.simulation",
         "--clients", str(clients), "--rounds", str(VAL_CLI_ROUNDS)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    require(out.returncode == 0,
            f"validation CLI exited {out.returncode}: {out.stderr[-2000:]}")
    cli = json.loads(out.stdout)
    require(cli["rounds_completed"] == VAL_CLI_ROUNDS
            and cli["stop_reason"] == "round_budget_exhausted",
            f"validation CLI: {cli['rounds_completed']} rounds, "
            f"{cli['stop_reason']}")
    from fl_tpu_torch.orchestration.simulation import require_grpc

    try:
        require_grpc()
        missing = None
    except ImportError as e:
        missing = str(e)
    if missing is None:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "grpc.json")
            t1 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "fl_tpu_torch.orchestration.simulation",
                 "--backend", "grpc", "--clients", "2", "--rounds", "1",
                 "--export", path], cwd=ROOT, capture_output=True, text=True,
                timeout=300)
            grpc_s = time.perf_counter() - t1
            require(out.returncode == 0,
                    f"validation CLI --backend grpc exited {out.returncode}: "
                    f"{out.stderr[-2000:]}")
            with open(path) as f:
                full = json.load(f)
        spent = [c["budget"]["consumed_epsilon"]
                 for c in full["client_results"].values()]
        require(full["rounds_completed"] == 1 and len(spent) == 2
                and all(abs(e - 1.0) < 1e-9 for e in spent),
                f"validation CLI --backend grpc: {full['rounds_completed']} "
                f"rounds, eps spent {spent}")
        grpc_note = (f"--backend grpc --clients 2 --rounds 1: exit 0 in "
                     f"{grpc_s:.1f}s, 1 round, eps spent {spent}")
    else:
        refused = subprocess.run(
            [sys.executable, "-m", "fl_tpu_torch.orchestration.simulation",
             "--backend", "grpc"], cwd=ROOT, capture_output=True,
            text=True, timeout=300)
        require(refused.returncode != 0 and "grpcio" in refused.stderr,
                "validation CLI: --backend grpc without grpcio was not "
                "refused naming it")
        grpc_note = f"--backend grpc refused naming grpcio ({missing})"
    print(f"validation CLI python -m fl_tpu_torch.orchestration.simulation "
          f"--clients {clients} --rounds {VAL_CLI_ROUNDS}: exit 0 in "
          f"{cli_s:.1f}s "
          f"(process start included), rounds/s {cli['rounds_per_sec']:.3f} "
          f"(wall {cli['wall_time_s']:.2f}s in the run), final accuracy "
          f"{cli['final_accuracy']:.4f}, eps spent "
          f"{cli['total_epsilon_spent']:.3f}; {grpc_note} [{card}]",
          flush=True)
    return k3


def validation_privacy(card):
    """``ComprehensiveValidator().run_all()`` on the card: the noise test
    through ``clip_noise_matrix`` (K3, 4 launches) and the split-budget
    test through the privacy engine's releases (K3 at scale 1, 5 launches;
    the 6th is refused before any noise); then numpy gradients through
    ``create_privacy_engine().add_noise``, which puts them on the card
    (K3, 1 launch). Returns K3's launches."""
    import numpy as np

    from fl_tpu_torch import ops
    from fl_tpu_torch.fl.privacy import create_privacy_engine, gaussian_sigma
    from fl_tpu_torch.validation import ComprehensiveValidator

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = ComprehensiveValidator().run_all()
    dt = time.perf_counter() - t0
    require(res["all_passed"], f"validation privacy: {res}")
    grads = {"w": np.full((65_536,), 0.01, np.float32),
             "b": np.zeros((10,), np.float32)}
    noisy = create_privacy_engine(seed=0).add_noise(grads, 0.5, 1e-6)
    k3 = _k3_since("validation privacy", 4 + 5 + 1)
    resid = noisy["w"] - 0.01 / float(np.sqrt(65_536 * 0.01 ** 2))
    ratio = float(resid.std()) / gaussian_sigma(1.0, 0.5, 1e-6)
    require(noisy["w"].is_cuda and abs(ratio - 1) < 0.02,
            f"validation privacy engine: numpy gradients released on "
            f"{noisy['w'].device}, noise std/sigma {ratio}")
    noise = res["noise"]
    print(f"validation PrivacyValidator: all passed in {dt:.2f}s; noise "
          f"std/sigma {noise['observed_ratio_min']:.4f}.."
          f"{noise['observed_ratio_max']:.4f} (band {noise['bounds']}), "
          f"budget {res['budget']['consumed_epsilon']:.3f} of 1, split "
          f"budget exhausted and the overdraw refused; numpy gradients "
          f"through create_privacy_engine().add_noise released on the card "
          f"(noise std/sigma {ratio:.4f}); K3 launches {k3} [{card}]",
          flush=True)
    return k3


def validation_attacks(card):
    """One inversion report (SimpleCNN, unfused: the attack's double
    backward), one membership report (the ``"residual"`` model trained to
    memorize 8 clients' 64 images) and one label-flip case (2 of 8
    attackers, 50x inflated counts): trimmed mean must beat FedAvg.
    Returns the launches."""
    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.core import prng
    from fl_tpu_torch.data import load_dataset, make_federated_arrays
    from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
    from fl_tpu_torch.models import create_model
    from fl_tpu_torch.orchestration import (FederatedRoundEngine,
                                            RoundEngineConfig)
    from fl_tpu_torch.validation import (InversionAttackConfig,
                                         evaluate_membership_risk,
                                         evaluate_poisoning_robustness,
                                         inversion_report)

    totals = {}

    def add(got):
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v

    ops.reset_launch_counts()
    splits = load_dataset("mnist", n_train_synth=1024, n_test_synth=512,
                          seed=3)
    model = create_model("simple_cnn")
    variables = {"params": model.init(prng.generator(7, DEVICE), DEVICE)}
    t0 = time.perf_counter()
    rep = inversion_report(
        model, variables, splits.train_images[:1], splits.train_labels[:1],
        splits.mean, splits.std,
        attack_config=InversionAttackConfig(steps=VAL_INV_STEPS, restarts=2))
    inv_s = time.perf_counter() - t0
    got, ok = _launched(clip_noise=1)  # the DP release
    require(ok, f"validation inversion: launches {got}")
    add(got)
    npv, dpv = rep["non_private"], rep["dp"]
    require(npv["mse"] < dpv["mse"] and rep["protected"]
            and npv["label_accuracy"] == 1.0,
            f"validation inversion: non-private mse {npv['mse']}, DP mse "
            f"{dpv['mse']}")
    print(f"validation inversion_report ({VAL_INV_STEPS} steps x 2 "
          f"restarts, batch 1): non-private PSNR {npv['psnr_db']:.2f} dB "
          f"(mse {npv['mse']:.4f}, label accuracy {npv['label_accuracy']}), "
          f"eps=1 DP PSNR {dpv['psnr_db']:.2f} dB (mse {dpv['mse']:.4f}, "
          f"sigma {dpv['noise_sigma']:.3f}); {inv_s:.2f}s for both attacks "
          f"({1e3 * inv_s / (2 * VAL_INV_STEPS):.2f} ms a step of 2 "
          f"restarts); K3 launches 1 [{card}]", flush=True)

    # membership: a model made to memorize its members
    arrays = make_federated_arrays(splits, num_clients=8, strategy="iid",
                                   samples_per_client=64, seed=0)
    cfg = RoundEngineConfig(training=FederatedTrainingConfig(
        local_epochs=5, batch_size=32, learning_rate=0.003), seed=0,
        max_clients=8)
    ops.reset_launch_counts()
    eng = FederatedRoundEngine(
        create_model("simple_cnn", fused_conv_block="residual"), arrays,
        cfg, device=DEVICE)
    for _ in range(8):
        eng.run_round(evaluate=False)
    nonmembers = load_dataset("mnist", n_train_synth=512, n_test_synth=64,
                              seed=11)
    t0 = time.perf_counter()
    mrep = evaluate_membership_risk(eng, nonmembers.train_images,
                                    nonmembers.train_labels)
    mem_s = time.perf_counter() - t0
    # 8 rounds x 5 epochs x 2 steps; the attack's 4 forwards (2 chunks of
    # 256 members, 2 of non-members)
    got, ok = _launched(conv_block_fwd=80 + 4, conv_block_bwd=80)
    require(ok, f"validation membership: launches {got}")
    add(got)
    require(mrep.n_members == 512 and 0.0 <= mrep.auc <= 1.0
            and math.isfinite(mrep.member_loss_mean)
            and math.isfinite(mrep.nonmember_loss_mean),
            f"validation membership: {mrep}")
    print(f"validation membership report (8 clients x 64, 8 rounds of 5 "
          f"epochs, 'residual'): AUC {mrep.auc:.4f}, advantage "
          f"{mrep.advantage:.4f}, member / non-member loss "
          f"{mrep.member_loss_mean:.4f} / {mrep.nonmember_loss_mean:.4f} "
          f"over {mrep.n_members} / {mrep.n_nonmembers}; the attack's "
          f"forward {1e3 * mem_s:.1f} ms [{card}]", flush=True)
    del eng

    # one label-flip case
    x_test = splits.normalized(splits.test_images)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pois = evaluate_poisoning_robustness(
        lambda: create_model("simple_cnn", fused_conv_block="residual"),
        arrays, x_test, splits.test_labels, attacker_ids=[1, 5],
        training=FederatedTrainingConfig(local_epochs=3, batch_size=16,
                                         learning_rate=0.05,
                                         optimizer_type="sgd"),
        aggregations=("fedavg", "trimmed_mean"), num_rounds=5,
        inflate_samples=50.0, seed=0)
    pois_s = time.perf_counter() - t0
    got = ops.launch_counts()
    require(got["conv_block_fwd"] > 0 and got["conv_block_bwd"] > 0
            and got["clip_noise"] == 0,
            f"validation poisoning: launches {got}")
    add(got)
    p = pois["poisoned"]
    require(p["trimmed_mean"] > p["fedavg"],
            f"validation poisoning: trimmed mean {p['trimmed_mean']} does "
            f"not beat FedAvg {p['fedavg']}")
    print(f"validation label flip (2 of 8 attackers, 50x counts, 5 rounds "
          f"'residual'): clean FedAvg {pois['clean_fedavg']:.4f}, poisoned "
          f"FedAvg {p['fedavg']:.4f}, trimmed mean {p['trimmed_mean']:.4f}; "
          f"{pois_s:.1f}s for the 3 engines [{card}]", flush=True)
    torch.cuda.empty_cache()
    return totals


def validation_analytics_vertical(card):
    """``dp_histogram`` at 4,096 clients x 16,384 buckets (a 256 MB int32
    count matrix summed and noised on the card) and the vertical engine
    with 4 parties over the 20,000-row synthetic MNIST."""
    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.data import load_dataset
    from fl_tpu_torch.fl import (VerticalConfig, VerticalFLEngine,
                                 dp_histogram, heavy_hitters, split_features)

    C, D = VAL_HIST
    rng = np.random.default_rng(0)
    w = 1.0 / (np.arange(D) + 1.0)
    sizes = rng.integers(1, 9, size=C)
    flat = rng.choice(D, size=int(sizes.sum()), p=w / w.sum())
    items = np.split(flat, np.cumsum(sizes)[:-1])
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = dp_histogram(items, D, epsilon=1.0, delta=1e-6,
                       max_items_per_client=8, seed=0)
    hist_s = time.perf_counter() - t0
    got, ok = _launched()
    require(ok, f"validation dp_histogram: launches {got}")
    truth = np.bincount(flat, minlength=D).astype(np.float64)
    noise = res.counts - truth
    hh = heavy_hitters(res, k=5, tau=4.0)
    require(res.participants == C and res.epsilon <= 1.0 + 1e-9
            and abs(noise.std() / res.sigma - 1) < 0.05
            and 0 in hh,
            f"validation dp_histogram: eps {res.epsilon}, noise std "
            f"{noise.std()} against sigma {res.sigma}, hitters {hh}")
    print(f"validation dp_histogram {C} clients x {D} buckets (int32 count "
          f"matrix {C * D * 4 / 2 ** 20:.0f} MiB): {1e3 * hist_s:.1f} ms "
          f"(host counts, upload, sum and noise), eps {res.epsilon:.4f}, "
          f"sigma {res.sigma:.3f}, noise std/sigma "
          f"{noise.std() / res.sigma:.4f}, heavy hitters {sorted(hh)} "
          f"[{card}]", flush=True)

    splits = load_dataset("mnist", n_train_synth=20_000, n_test_synth=4_000)
    x = splits.normalized(splits.train_images)
    xt = splits.normalized(splits.test_images)
    eng = VerticalFLEngine(split_features(x, VAL_PARTIES),
                           splits.train_labels, 10, VerticalConfig(),
                           test_splits=split_features(xt, VAL_PARTIES),
                           test_labels=splits.test_labels)
    times, logs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs.append(eng.run_epoch())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ev = eng.evaluate()
    require(ev["accuracy"] > 0.8 and logs[1]["train_loss"]
            < logs[0]["train_loss"], f"validation vertical: {logs} {ev}")
    print(f"validation vertical FL ({VAL_PARTIES} parties x "
          f"{x[0].size // VAL_PARTIES} columns, 20,000 rows, batch 64): "
          f"epochs {[round(t, 3) for t in times]} s "
          f"({int(20_000 // 64) / times[1]:.0f} steps/s), train loss "
          f"{[round(l['train_loss'], 4) for l in logs]}, test accuracy "
          f"{ev['accuracy']:.4f}; exchanged {eng.exchanged_bytes_per_epoch()}"
          f" B an epoch against {eng.raw_feature_bytes()} B of raw columns "
          f"[{card}]", flush=True)


def phase_validation(card, counts):
    """The simulation entry point, the validation harness (privacy,
    security, inversion, membership, poisoning), federated analytics and
    vertical FL on the card. K3's launches on the new paths (the
    simulation's delta-DP rounds, the validators' releases, the inversion
    report's DP release) join ``counts``, and so do K1/K2's."""
    t_phase = time.perf_counter()
    validation_k3_check(card)
    k3 = validation_simulation(card)
    k3 += validation_privacy(card)
    attacks = validation_attacks(card)
    validation_analytics_vertical(card)
    for k, v in attacks.items():
        counts[k] = counts.get(k, 0) + v
    counts["clip_noise"] = counts.get("clip_noise", 0) + k3
    print(f"validation: K3 launches on the new paths {k3 + attacks['clip_noise']}"
          f" (simulation, validators, inversion); phase "
          f"{time.perf_counter() - t_phase:.1f}s [{card}]", flush=True)


# the deployment round (phase_deployment): the reference's backend="grpc"
# topology, 8 FederatedTrainer threads on one card against the coordinator
# servicer over localhost gRPC, delta DP at (3, 1e-5) over 3 rounds
DEPLOY_CLIENTS = 8
DEPLOY_ROUNDS = 3
DEPLOY_SYNTH = 8_192        # the synthetic MNIST's training images
DEPLOY_BATCH = 32
DEPLOY_EPS, DEPLOY_DELTA = 3.0, 1e-5
DEPLOY_AGG_TOL = 1e-6       # the global model against float64, of a leaf's
                            # largest value
SIMPLE_CNN_PARAMS = 421_642
DEPLOY_POLL_S = 0.02        # the FSM's status poll while it waits


class DeployRecord:
    """What crossed the wire in a deployment run: the weights the
    coordinator served each round, each client's decoded download and its
    upload as sent, each aggregation's decoded uploads, result and
    seconds, and every transfer whose decoded arrays were not bit-equal
    (values and dtypes) to what the other side sent."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.served = {}      # round -> the global weights served
        self.downloads = {}   # (client, round) -> the decoded download
        self.sent = {}        # (client, round) -> the upload as sent
        self.uploads = {}     # round -> [(client, samples, decoded upload)]
        self.results = {}     # round -> the aggregated weights
        self.aggregate_s = []
        self.mismatches = []

    @staticmethod
    def _numpy(weights):
        from fl_tpu_torch.core.types import to_numpy

        return {k: to_numpy(v) for k, v in weights.items()}

    def same(self, sent, back, what):
        import numpy as np

        if set(back) != set(sent) or not all(
                back[k].dtype == sent[k].dtype
                and np.array_equal(back[k], sent[k]) for k in sent):
            with self.lock:
                self.mismatches.append(what)

    def watch_initial(self, servicer):
        """The servicer's lazy initial model, recorded as round 0's."""
        make = servicer._create_initial_global_model

        def initial():
            gm = make()
            self.served[0] = self._numpy(gm.model_weights)
            return gm

        servicer._create_initial_global_model = initial

    def watch_coordinator(self, aggregator):
        """Each aggregation's decoded uploads, result and seconds (the card
        synchronized at both ends); its result is the next round's served
        model."""
        import torch

        inner = aggregator.aggregate_updates

        def aggregate_updates(updates):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = inner(updates)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rnd = updates[0].round_number
            result = self._numpy(model.model_weights)
            with self.lock:
                self.aggregate_s.append(dt)
                self.uploads[rnd] = [(u.client_id, u.num_samples,
                                      self._numpy(u.model_weights))
                                     for u in updates]
                self.results[rnd] = result
                self.served[rnd + 1] = result
            return model

        aggregator.aggregate_updates = aggregate_updates

    def watch_client(self, client):
        """A client's download held to what was served; its upload kept as
        sent."""
        get, submit = client.get_global_model, client.submit_model_update

        def get_global_model(round_number=-1, *args, **kwargs):
            gm = get(round_number, *args, **kwargs)
            self.same(self.served.get(round_number, {}), gm.model_weights,
                       f"{client.client_id}'s download of round "
                       f"{round_number}")
            with self.lock:
                self.downloads[(client.client_id, round_number)] = \
                    gm.model_weights
            return gm

        def submit_model_update(update):
            with self.lock:
                self.sent[(update.client_id, update.round_number)] = \
                    self._numpy(update.model_weights)
            return submit(update)

        client.get_global_model = get_global_model
        client.submit_model_update = submit_model_update

    def check_wire(self, clients, rounds):
        """Every upload that was sent reached its round's aggregation
        bit-equal, and every download was what was served."""
        for (cid, rnd), sent in self.sent.items():
            back = [w for c, _, w in self.uploads.get(rnd, []) if c == cid]
            self.same(sent, back[0] if back else {},
                       f"{cid}'s upload of round {rnd}")
        require(len(self.sent) == clients * rounds
                and len(self.downloads) == clients * rounds
                and all(len(self.uploads.get(r, ())) == clients
                        for r in range(rounds)),
                f"deployment: {len(self.sent)} uploads sent, "
                f"{len(self.downloads)} downloads, aggregated "
                f"{[len(self.uploads.get(r, ())) for r in range(rounds)]}")
        require(not self.mismatches,
                f"deployment: the wire changed {self.mismatches[:3]}")

    def mean_gap(self, rounds):
        """The largest |global − float64 sample-weighted mean of the
        decoded uploads| over rounds, of each leaf's largest |mean|;
        required within DEPLOY_AGG_TOL."""
        import numpy as np

        worst = 0.0
        for rnd in range(rounds):
            ups = self.uploads[rnd]
            total = float(sum(n for _, n, _ in ups))
            for k, got in self.results[rnd].items():
                want = sum((n / total) * w[k].astype(np.float64)
                           for _, n, w in ups)
                gap = np.abs(got.astype(np.float64) - want).max()
                worst = max(worst,
                            float(gap / max(np.abs(want).max(), 1e-30)))
        require(worst <= DEPLOY_AGG_TOL,
                f"deployment: global model vs float64 mean {worst}")
        return worst


def require_deployment_packages():
    """The deployment phases need ``grpcio`` and ``protobuf``: fail the run
    naming them where they do not import."""
    from fl_tpu_torch.orchestration.simulation import require_grpc

    try:
        require_grpc()
    except ImportError as e:
        raise SmokeFailure(f"deployment: {e}") from e


def deployment_k3_check(card, rec, privacy, eps_r, delta_r):
    """K3 at the FSM's release shape (1, 421,642): one client's delta (its
    round-0 upload less the global model it downloaded), whose norm lies
    above the clip norm, through ``clip_and_noise_tree`` at sigma 0 (eps
    inf) bit-equal to ``use_pallas=False``; at the round's (eps_r,
    delta_r) the noise's std/sigma within 2%; K3's and the plain version's
    ms. Comparison launches: not counted."""
    import numpy as np
    import torch

    from fl_tpu_torch.fl.privacy import clip_and_noise_tree
    from fl_tpu_torch.ops import dp as dp_ops

    cid = min(c for c, r in rec.sent if r == 0)
    up, base = rec.sent[(cid, 0)], rec.downloads[(cid, 0)]
    delta = {k: torch.as_tensor(up[k] - np.asarray(base[k])).to(DEVICE)
             for k in up}
    norm = float(torch.sqrt(sum(v.double().square().sum()
                                for v in delta.values())))
    c = privacy.max_grad_norm
    got, sens, sig = clip_and_noise_tree(delta, 7, math.inf, delta_r, c)
    want, wsens, wsig = clip_and_noise_tree(delta, 7, math.inf, delta_r, c,
                                            use_pallas=False)
    equal = all(torch.equal(got[k], want[k]) for k in got)
    require(norm > c and equal and float(sig) == 0.0
            and torch.equal(sens, wsens),
            f"deployment K3: the sigma-0 release differs from the plain "
            f"version (delta norm {norm}, clip {c}, sigma {float(sig)})")
    noisy, sens, sig = clip_and_noise_tree(delta, 8, eps_r, delta_r, c)
    scale = c / norm
    resid = torch.cat([(noisy[k] - delta[k] * scale).reshape(-1)
                       for k in noisy]).double()
    ratio = float(resid.std() / sig)
    require(abs(ratio - 1.0) < 0.02 and abs(float(resid.mean() / sig))
            < 5.0 / math.sqrt(SIMPLE_CNN_PARAMS),
            f"deployment K3: noise std/sigma {ratio}")
    row = torch.cat([v.reshape(-1) for v in delta.values()])[None]
    ms = time_ms(lambda: dp_ops.clip_noise_matrix(row, [9], eps_r, delta_r,
                                                  c))
    plain_ms = time_ms(lambda: dp_ops.clip_noise_matrix(
        row, [9], eps_r, delta_r, c, use_pallas=False))
    b_ms, b_by = bound(8 * row.numel() + 2 * 16, 10 * row.numel(),
                       F32_FLOPS)
    print(f"deployment K3 clip_and_noise_tree (1, {row.shape[1]:,}), delta "
          f"norm {norm:.1f} over clip {c}: sigma=0 bit-equal to the plain "
          f"version; at eps_r={eps_r} noise std/sigma {ratio:.4f}; "
          f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms by "
          f"{b_by}) [{card}]", flush=True)


def deployment_simulation_smoke(card):
    """``FederatedLearningSimulation(backend="grpc")`` for one round of 2
    clients over localhost: its servicer's aggregate held to the float64
    mean of the decoded uploads, each client's eps spent 1.0. A smoke, not
    a measurement. Returns K3's launches."""
    from fl_tpu_torch import ops
    from fl_tpu_torch.orchestration.simulation import (
        FederatedLearningSimulation, SimulationConfig)
    from fl_tpu_torch.services import grpc_server

    rec, made = DeployRecord(), []
    init_fn = grpc_server.FederatedLearningServicer.__init__

    def watched(self, *args, **kwargs):
        init_fn(self, *args, **kwargs)
        rec.watch_initial(self)
        rec.watch_coordinator(self.aggregator)
        made.append(self)

    grpc_server.FederatedLearningServicer.__init__ = watched
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = FederatedLearningSimulation(SimulationConfig(
            backend="grpc", num_clients=2, num_rounds=1, local_epochs=1,
            n_train_synth=2_048, timeout_s=300),
            device=DEVICE).run_simulation()
    finally:
        grpc_server.FederatedLearningServicer.__init__ = init_fn
    wall = time.perf_counter() - t0
    k3 = ops.launch_counts()["clip_noise"]
    spent = [c["budget"]["consumed_epsilon"]
             for c in res["client_results"].values()]
    require(res["rounds_completed"] == 1 and k3 == 2 and len(made) == 1
            and len(rec.uploads.get(0, ())) == 2
            and all(abs(e - 1.0) < 1e-9 for e in spent),
            f"deployment simulation: {res['rounds_completed']} rounds, K3 "
            f"{k3}, aggregated {len(rec.uploads.get(0, ()))}, eps {spent}")
    final = DeployRecord._numpy(made[0].global_model.model_weights)
    rec.same(rec.results[0], final, "the servicer's global model")
    require(not rec.mismatches, "deployment simulation: the servicer's "
            "global model is not its aggregate")
    gap = rec.mean_gap(1)
    print(f"deployment smoke FederatedLearningSimulation(backend='grpc', 2 "
          f"clients, 1 round) over localhost: {res['stop_reason']}, "
          f"{wall:.2f}s, the servicer's global vs float64 mean {gap:.2e}, "
          f"eps spent {spent}, K3 launches {k3} [{card}]", flush=True)
    return k3


def phase_deployment(card, counts):
    """The deployment round on the card: 8 ``FederatedTrainer`` threads
    (mnist, non-IID over 8,192 synthetic images, local_epochs 1, batch 32,
    delta DP at (3, 1e-5) over 3 rounds) against the port's
    ``FederatedLearningServicer`` (FedAvgAggregator on the card, the
    DP-widened validator, aggregation on its one-worker executor) over
    localhost gRPC; the phase fails naming ``grpcio`` where it does not
    import. K3 carries each client's release, DEPLOY_CLIENTS x
    DEPLOY_ROUNDS launches; then the grpc backend's simulation smoke. The
    launches join ``counts``."""
    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.core.types import PrivacyConfig, RoundConfig
    from fl_tpu_torch.ops import dp as dp_ops
    from fl_tpu_torch.services.federated_trainer import FederatedTrainer

    t_phase = time.perf_counter()
    require_deployment_packages()
    from fl_tpu_torch.services.grpc_server import (
        CoordinatorGRPCServer, FederatedLearningServicer)

    privacy = PrivacyConfig(DEPLOY_EPS, DEPLOY_DELTA)
    eps_r, delta_r = DEPLOY_EPS / DEPLOY_ROUNDS, DEPLOY_DELTA / DEPLOY_ROUNDS
    cfg = RoundConfig(min_clients=DEPLOY_CLIENTS,
                      max_clients=DEPLOY_CLIENTS, local_epochs=1,
                      batch_size=DEPLOY_BATCH, learning_rate=1e-3,
                      privacy_config=privacy)
    rec = DeployRecord()
    servicer = FederatedLearningServicer(round_config=cfg, device=DEVICE)
    rec.watch_initial(servicer)
    rec.watch_coordinator(servicer.aggregator)
    server = CoordinatorGRPCServer(servicer, host="127.0.0.1", port=0)
    port = server.start()
    trainers = []
    for i in range(DEPLOY_CLIENTS):
        t = FederatedTrainer(
            client_id=f"edge_{i}", coordinator_host="127.0.0.1",
            coordinator_port=port, dataset="mnist", privacy=privacy,
            epsilon_per_round=eps_r, delta_per_round=delta_r,
            client_index=i, num_clients=DEPLOY_CLIENTS,
            partition_strategy="non_iid", poll_interval_s=DEPLOY_POLL_S,
            max_rounds=DEPLOY_ROUNDS, n_train_synth=DEPLOY_SYNTH,
            n_test_synth=1_024, device=DEVICE)
        t.initialize()
        rec.watch_client(t.client)
        trainers.append(t)
    # K3 compiled before the threads start (its first call compiles)
    dp_ops.clip_noise_matrix(torch.zeros((1, 4096), device=DEVICE), [1],
                             1.0, 1e-5, 1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for t in trainers:
        t.start_training()
    while time.perf_counter() < t0 + 240 and (
            len(rec.results) < DEPLOY_ROUNDS
            or any(t.rounds_completed < DEPLOY_ROUNDS for t in trainers)):
        time.sleep(0.005)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3 = ops.launch_counts()["clip_noise"]
    got, only_k3 = _launched(clip_noise=k3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for t in trainers:
        t.stop_training()
    server.stop()
    hist = [h for t in trainers for h in t.training_history]
    require(len(rec.results) == DEPLOY_ROUNDS
            and all(t.rounds_completed == DEPLOY_ROUNDS for t in trainers),
            f"deployment: aggregated rounds {sorted(rec.results)}, client "
            f"rounds {[t.rounds_completed for t in trainers]}, states "
            f"{[t.state.value for t in trainers]}")
    require(sum(v.size for v in rec.served[0].values())
            == SIMPLE_CNN_PARAMS, "deployment: SimpleCNN is not at full "
            "width")
    require(k3 == DEPLOY_CLIENTS * DEPLOY_ROUNDS and only_k3,
            f"deployment: launches {got}, expected clip_noise="
            f"{DEPLOY_CLIENTS * DEPLOY_ROUNDS} and nothing else")
    rec.check_wire(DEPLOY_CLIENTS, DEPLOY_ROUNDS)
    gap = rec.mean_gap(DEPLOY_ROUNDS)
    for t in trainers:
        spent = [e["epsilon"] for e in
                 t.budget_tracker.consumption_history]
        require(spent == [eps_r] * DEPLOY_ROUNDS
                and abs(t.budget_tracker.consumed_epsilon - DEPLOY_EPS)
                < 1e-9,
                f"deployment: {t.client_id} spent {spent}")
    require(all(math.isfinite(h["loss"]) for h in hist),
            f"deployment: losses {[h['loss'] for h in hist]}")
    deployment_k3_check(card, rec, privacy, eps_r, delta_r)
    med = lambda xs: 1e3 * float(np.median(xs))  # noqa: E731
    print(f"deployment {DEPLOY_CLIENTS} FederatedTrainer threads x "
          f"{DEPLOY_ROUNDS} rounds (SimpleCNN {SIMPLE_CNN_PARAMS:,} "
          f"params, non-IID over {DEPLOY_SYNTH} images, batch "
          f"{DEPLOY_BATCH}, delta DP eps {DEPLOY_EPS} over "
          f"{DEPLOY_ROUNDS} rounds) against FederatedLearningServicer over "
          f"localhost gRPC: "
          f"{DEPLOY_ROUNDS / wall:.3f} rounds/s wall clock ({wall:.2f}s); "
          f"median ms a client: train {med([h['train_s'] for h in hist]):.1f}"
          f", DP {med([h['privacy_s'] for h in hist]):.2f}, compress "
          f"{med([h['compress_s'] for h in hist]):.1f}, upload (encode, "
          f"send, decode) {med([h['upload_s'] for h in hist]):.2f}, whole "
          f"round {med([h['time_s'] for h in hist]):.1f}; aggregation "
          f"{med(rec.aggregate_s):.2f} ms (median of {len(rec.aggregate_s)})"
          f"; peak memory {peak:.3f} GiB; K3 launches {k3}; global vs "
          f"float64 mean {gap:.2e} of a leaf's largest; wire bit-equal both "
          f"ways; eps spent {eps_r} a round a client; losses "
          f"{[round(h['loss'], 2) for h in hist[:DEPLOY_ROUNDS]]} "
          f"(edge_0) [{card}]", flush=True)
    k3 += deployment_simulation_smoke(card)
    counts["clip_noise"] = counts.get("clip_noise", 0) + k3
    print(f"deployment: K3 launches on the new path {k3}; phase "
          f"{time.perf_counter() - t_phase:.1f}s [{card}]", flush=True)


# the secure deployment (phase_secure_deployment): the deployment round's
# 8 FSM threads at SimpleCNN's full width, masked by Bonawitz secure
# aggregation over localhost gRPC. Delta DP at eps_r = 20 (sigma 0.249 on
# the noised weights) keeps every upload inside fp_encode's bound
# |n theta| 2^16 < 2^31 / 8, i.e. |theta| < 2.80 at the largest non-IID
# shard (1,461 images); the deployment round's eps_r = 1 (sigma ~5) is
# refused there, as in the reference
SECURE_ROUNDS = 2
SECURE_EPS, SECURE_DELTA = 40.0, 1e-5
SECURE_GRACE_S = 1.0        # the dropout round's wait for stragglers
DDP_Z, DDP_BITS = 1.0, 14   # distributed DP: sigma 0.130 on the average
DDP_BUDGET = 8.0            # the client's ledger; one round charges 5.30
CLI_CLIENTS = 2
CLI_SHARDS = 16             # the client CLI's split of its 20,000 images


class SecureRecord:
    """What the secure rounds released and unmasked: each client's
    pre-mask payload (the weights ``mask_payload`` was given, with its
    sample count), each ``unmask_aggregate``'s result and host seconds,
    and each distributed-DP client's delta and plan. Wraps the protocol's
    classes for the phase; ``restore`` puts them back."""

    def __init__(self):
        import threading

        from fl_tpu_torch.services import federated_trainer, secagg_wire

        self.lock = threading.Lock()
        self.payloads = {}   # round -> {client: (n, weights)}
        self.unmasked = {}   # round -> (weights, seconds)
        self.ddp = {}        # client -> (flat delta, plan)
        self._saved = [
            (secagg_wire.SecAggClientSession, "mask_payload"),
            (secagg_wire.SecAggServerRound, "unmask_aggregate"),
            (federated_trainer, "host_client_integer_payload")]
        self._saved = [(o, n, getattr(o, n)) for o, n in self._saved]
        rec = self
        mask, unmask, ddp = (f for _, _, f in self._saved)

        def mask_payload(session, weights, num_samples):
            import numpy as np

            with rec.lock:
                rec.payloads.setdefault(session.round_number, {})[
                    session.client_id] = (int(num_samples), {
                        k: np.array(v) for k, v in weights.items()})
            return mask(session, weights, num_samples)

        def unmask_aggregate(rnd, updates):
            t0 = time.perf_counter()
            model = unmask(rnd, updates)
            dt = time.perf_counter() - t0
            with rec.lock:
                rec.unmasked[rnd.round_number] = (dict(model.model_weights),
                                                  dt)
            return model

        def host_client_integer_payload(delta, plan, rng):
            import numpy as np

            flat = np.concatenate([np.asarray(delta[k], np.float64).ravel()
                                   for k in sorted(delta)])
            with rec.lock:
                rec.ddp[len(rec.ddp)] = (flat, plan)
            return ddp(delta, plan, rng)

        for (o, n, _), f in zip(self._saved, (mask_payload, unmask_aggregate,
                                              host_client_integer_payload)):
            setattr(o, n, f)

    def restore(self):
        for o, n, f in self._saved:
            setattr(o, n, f)

    def mean_gap(self, rnd, survivors):
        """The largest |unmasked - float64 sample-weighted mean of the
        survivors' pre-mask payloads| of round ``rnd``."""
        import numpy as np

        got, _ = self.unmasked[rnd]
        ups = [self.payloads[rnd][c] for c in survivors]
        total = float(sum(n for n, _ in ups))
        worst = 0.0
        for k, v in got.items():
            want = sum(n * w[k].astype(np.float64) for n, w in ups) / total
            worst = max(worst, float(np.abs(v.astype(np.float64)
                                            - want).max()))
        return worst

    def largest_upload(self):
        """max |n theta| over every recorded payload, and its share of
        fp_encode's per-client limit 2^31 / (roster 2^16)."""
        import numpy as np

        worst = max(n * float(np.abs(v).max())
                    for per in self.payloads.values()
                    for n, w in per.values() for v in w.values())
        return worst, worst / (2.0 ** 31 / (DEPLOY_CLIENTS * 2 ** 16))


def secure_trainers(port, rounds, privacy, eps_r, delta_r, **kw):
    """The deployment round's 8 FSMs, secure, against ``port``."""
    from fl_tpu_torch.services.federated_trainer import FederatedTrainer

    trainers = []
    for i in range(DEPLOY_CLIENTS):
        t = FederatedTrainer(
            client_id=f"edge_{i}", coordinator_host="127.0.0.1",
            coordinator_port=port, dataset="mnist", privacy=privacy,
            epsilon_per_round=eps_r, delta_per_round=delta_r,
            client_index=i, num_clients=DEPLOY_CLIENTS,
            partition_strategy="non_iid", poll_interval_s=DEPLOY_POLL_S,
            max_rounds=rounds, n_train_synth=DEPLOY_SYNTH,
            n_test_synth=1_024, secure_aggregation=True, device=DEVICE,
            **kw)
        t.initialize()
        trainers.append(t)
    return trainers


def run_trainers(trainers, servicer, until_round, what, limit_s=240):
    """Start the FSMs and wait until the servicer reached ``until_round``
    and every live FSM completed its rounds; returns the wall seconds."""
    import torch

    t0 = time.perf_counter()
    for t in trainers:
        t.start_training()
    while time.perf_counter() < t0 + limit_s and (
            servicer.current_round < until_round or servicer._aggregating
            or any(t.rounds_completed < t.max_rounds for t in trainers
                   if not t._stop.is_set())):
        time.sleep(0.005)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for t in trainers:
        t.stop_training()
    require(servicer.current_round == until_round,
            f"{what}: the servicer is at round {servicer.current_round}, "
            f"expected {until_round}; client states "
            f"{[t.state.value for t in trainers]}")
    return wall


def secure_servicer(model_dir=None, **kw):
    """The port's servicer at the deployment round's config, secure, with
    its gRPC server on a free localhost port; persistence in
    ``model_dir`` where given."""
    from fl_tpu_torch.core.types import RoundConfig
    from fl_tpu_torch.services.grpc_server import (
        CoordinatorGRPCServer, FederatedLearningServicer)
    from fl_tpu_torch.services.persistence import CoordinatorPersistence

    pc = kw.pop("privacy_config", None)
    cfg = RoundConfig(min_clients=DEPLOY_CLIENTS, max_clients=DEPLOY_CLIENTS,
                      local_epochs=1, batch_size=DEPLOY_BATCH,
                      learning_rate=1e-3, privacy_config=pc)
    servicer = FederatedLearningServicer(
        round_config=cfg, secure_aggregation=True, device=DEVICE,
        persistence=(CoordinatorPersistence(model_dir) if model_dir
                     else None), **kw)
    server = CoordinatorGRPCServer(servicer, host="127.0.0.1", port=0)
    return servicer, server, server.start()


def secure_cli_services(card, model_dir):
    """The two command lines' services in process, from dict configs: a
    ``CoordinatorService`` (gRPC and REST on free ports, persistence in
    ``model_dir``) and 2 ``ClientService``s (their trainers on the card,
    delta DP at eps 8) for one round; then /health, /status and
    /metrics/prometheus over HTTP and the reverse-order shutdown. Returns
    (K3 launches, seconds)."""
    import threading
    import urllib.request

    from fl_tpu_torch import ops
    from fl_tpu_torch.services import client_main, coordinator_main

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    coord = coordinator_main.CoordinatorService({
        "server": {"host": "127.0.0.1", "grpc_port": 0, "http_port": 0},
        "training": {"min_clients": CLI_CLIENTS, "max_clients": CLI_CLIENTS,
                     "local_epochs": 1, "batch_size": DEPLOY_BATCH,
                     "learning_rate": 1e-3},
        "privacy": {"enabled": True, "epsilon": 8.0, "delta": 1e-5},
        "storage": {"model_dir": model_dir}}, device=DEVICE)
    coord.start()
    order = []
    for name, stop in (("rest_api", "stop_server"), ("grpc_server", "stop"),
                       ("metrics_tracker", "stop"), ("round_manager", "stop"),
                       ("database", "close")):
        comp = getattr(coord, name)
        inner = getattr(comp, stop)

        def wrapped(*a, _inner=inner, _name=name, **kw):
            order.append(_name)
            return _inner(*a, **kw)

        setattr(comp, stop, wrapped)
    services = [client_main.ClientService({
        "client": {"id": f"cli_{i}", "coordinator_host": "127.0.0.1",
                   "coordinator_port": coord.grpc_server.port},
        "privacy": {"enabled": True, "epsilon": 8.0, "delta": 1e-5},
        "data": {"num_clients": CLI_SHARDS, "partition_strategy": "iid"}},
        device=DEVICE) for i in range(CLI_CLIENTS)]
    threads = [threading.Thread(target=svc.start, daemon=True)
               for svc in services]
    for th in threads:
        th.start()
    servicer = coord.grpc_server.servicer
    while time.perf_counter() < t0 + 240 and (
            servicer.current_round < 1 or any(
                svc.trainer is None or svc.trainer.rounds_completed < 1
                for svc in services)):
        time.sleep(0.01)
    base = f"http://127.0.0.1:{coord.rest_api.port}"
    with urllib.request.urlopen(base + "/health", timeout=10) as r:
        health = json.load(r)
    with urllib.request.urlopen(base + "/status", timeout=10) as r:
        status = json.load(r)
    with urllib.request.urlopen(base + "/metrics/prometheus",
                                timeout=10) as r:
        prom = r.read().decode()
    for svc in services:
        svc.stop()
    for th in threads:
        th.join(timeout=30)
    coord.stop()
    k3 = ops.launch_counts()["clip_noise"]
    require(servicer.current_round == 1 and status["grpc"] == {
        "current_round": 1, "registered_clients": ["cli_0", "cli_1"],
        "pending_updates": 0, "global_model_round": 0},
        f"secure deployment CLIs: round {servicer.current_round}, REST "
        f"/status {status.get('grpc')}")
    require(health["status"] == "healthy"
            and "# TYPE fl_current_round gauge" in prom
            and "fl_registered_clients" in prom,
            f"secure deployment CLIs: /health {health}, prometheus {prom!r}")
    require(order == ["rest_api", "grpc_server", "metrics_tracker",
                      "round_manager", "database"]
            and not any(th.is_alive() for th in threads),
            f"secure deployment CLIs: shutdown order {order}")
    require(k3 == CLI_CLIENTS, f"secure deployment CLIs: K3 {k3}")
    wall = time.perf_counter() - t0
    print(f"secure deployment CLIs: CoordinatorService (gRPC :"
          f"{coord.grpc_server.port}, REST :{coord.rest_api.port}, "
          f"persistence) + {CLI_CLIENTS} ClientService threads, one round "
          f"in {wall:.2f}s; /health, /status (the servicer at round 1, "
          f"clients {status['grpc']['registered_clients']}) and "
          f"/metrics/prometheus ({len(prom.splitlines())} lines) answered; "
          f"shutdown REST -> gRPC -> metrics -> rounds -> database; K3 "
          f"launches {k3} [{card}]", flush=True)
    return k3


def phase_secure_deployment(card, counts):
    """The secure deployment on the card (DEPLOY_CLIENTS FSM threads,
    SimpleCNN's full width, localhost gRPC):

    (a) SECURE_ROUNDS masked rounds at delta DP (SECURE_EPS over the
        rounds) against a servicer that persists each global model: each
        unmasked aggregate within roster 2^-16 of the float64 sample-
        weighted mean of the pre-mask payloads, K3 exactly clients x
        rounds and nothing else;
    (d) a servicer restarted on the same directory resumes at the next
        round with the global model bit-equal;
    (b) on it, one round in which one client stops after the share phase:
        it completes on the 7 survivors' mean;
    (c) one distributed-DP round: no K3 launch, each client charged
        ``distributed_epsilon`` at the threshold, ``ddp_epsilon_total``
        the realized charge, the decoded average's noise std within 5% of
        the plan's sigma;
    (e) the two command lines' services for one round, REST read over
        HTTP.

    Where ``cryptography`` does not import, prints that the phase did not
    run. The launches join ``counts``."""
    import shutil

    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.core.types import PrivacyConfig, to_numpy
    from fl_tpu_torch.fl.distributed_dp import distributed_epsilon
    from fl_tpu_torch.ops import dp as dp_ops

    try:
        import cryptography  # noqa: F401
    except ImportError as e:
        print(f"secure deployment: NOT RUN, the cryptography package does "
              f"not import ({e}) [{card}]", flush=True)
        return
    t_phase = time.perf_counter()
    require_deployment_packages()
    model_dir = tempfile.mkdtemp(prefix="fl_secure_")
    rec = SecureRecord()
    try:
        # (a) the masked rounds
        privacy = PrivacyConfig(SECURE_EPS, SECURE_DELTA)
        eps_r = SECURE_EPS / SECURE_ROUNDS
        delta_r = SECURE_DELTA / SECURE_ROUNDS
        servicer, server, port = secure_servicer(
            model_dir, privacy_config=privacy,
            secagg_threshold=DEPLOY_CLIENTS)
        trainers = secure_trainers(port, SECURE_ROUNDS, privacy, eps_r,
                                   delta_r)
        dp_ops.clip_noise_matrix(torch.zeros((1, 4096), device=DEVICE), [1],
                                 1.0, 1e-5, 1.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        wall = run_trainers(trainers, servicer, SECURE_ROUNDS,
                            "secure deployment (a)")
        k3 = ops.launch_counts()["clip_noise"]
        got, only_k3 = _launched(clip_noise=k3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        final = {k: to_numpy(v)
                 for k, v in servicer.global_model.model_weights.items()}
        server.stop()
        servicer.persistence.repository.db.close()
        require(k3 == DEPLOY_CLIENTS * SECURE_ROUNDS and only_k3,
                f"secure deployment (a): launches {got}, expected "
                f"clip_noise={DEPLOY_CLIENTS * SECURE_ROUNDS} and nothing "
                "else")
        require(sum(v.size for v in final.values()) == SIMPLE_CNN_PARAMS,
                "secure deployment: SimpleCNN is not at full width")
        ids = [t.client_id for t in trainers]
        grid = DEPLOY_CLIENTS * 2.0 ** -16
        gaps = [rec.mean_gap(r, ids) for r in range(SECURE_ROUNDS)]
        require(sorted(rec.unmasked) == list(range(SECURE_ROUNDS))
                and all(g <= grid for g in gaps)
                and all(np.isfinite(v).all() for v in final.values()),
                f"secure deployment (a): unmasked rounds "
                f"{sorted(rec.unmasked)}, gaps to the float64 mean {gaps} "
                f"(grid {grid})")
        last, _ = rec.unmasked[SECURE_ROUNDS - 1]
        require(all(np.array_equal(last[k], final[k]) for k in final),
                "secure deployment (a): the global model is not the "
                "unmasked aggregate")
        for t in trainers:
            spent = [e["epsilon"] for e in
                     t.budget_tracker.consumption_history]
            require(spent == [eps_r] * SECURE_ROUNDS,
                    f"secure deployment (a): {t.client_id} spent {spent}")
        upload, share = rec.largest_upload()
        hist = [h for t in trainers for h in t.training_history]
        med = lambda key: 1e3 * float(np.median(  # noqa: E731
            [h[key] for h in hist]))
        unmask_ms = [1e3 * rec.unmasked[r][1] for r in range(SECURE_ROUNDS)]
        print(f"secure deployment (a) {DEPLOY_CLIENTS} FederatedTrainer "
              f"threads x {SECURE_ROUNDS} masked rounds (SimpleCNN "
              f"{SIMPLE_CNN_PARAMS:,} params, non-IID over {DEPLOY_SYNTH} "
              f"images, threshold {DEPLOY_CLIENTS}, delta DP eps_r {eps_r} "
              f"on K3) over localhost gRPC: {SECURE_ROUNDS / wall:.3f} "
              f"rounds/s wall clock ({wall:.2f}s); median ms a client: "
              f"train {med('train_s'):.1f}, DP {med('privacy_s'):.2f}, "
              f"roster {med('secagg_roster_s'):.1f}, shares "
              f"{med('secagg_share_s'):.1f}, mask {med('secagg_mask_s'):.1f}"
              f", upload {med('upload_s'):.1f}, reveal "
              f"{med('secagg_reveal_s'):.1f}, whole round "
              f"{med('time_s'):.1f}; unmask {unmask_ms[0]:.1f} / "
              f"{unmask_ms[1]:.1f} ms on the host; unmasked vs float64 mean "
              f"{max(gaps):.2e} (grid {grid:.2e}); largest |n theta| "
              f"{upload:.1f}, {share:.3f} of fp_encode's limit; peak memory "
              f"{peak:.3f} GiB; K3 launches {k3} [{card}]", flush=True)

        # (d) the restart, then (b) the dropout round on it
        servicer, server, port = secure_servicer(
            model_dir, privacy_config=privacy,
            secagg_threshold=DEPLOY_CLIENTS - 1,
            secagg_grace_s=SECURE_GRACE_S)
        resumed = {k: np.asarray(v)
                   for k, v in servicer.global_model.model_weights.items()}
        require(servicer.current_round == SECURE_ROUNDS
                and all(resumed[k].dtype == final[k].dtype
                        and np.array_equal(resumed[k], final[k])
                        for k in final),
                f"secure deployment (d): the restart resumed at round "
                f"{servicer.current_round}, model bit-equal "
                f"{[k for k in final if np.array_equal(resumed[k], final[k])]}")
        print(f"secure deployment (d) restart: a new servicer on the same "
              f"model_dir resumed at round {servicer.current_round} with "
              f"the global model bit-equal ({len(final)} tensors) "
              f"[{card}]", flush=True)
        trainers = secure_trainers(port, 1, privacy, eps_r, delta_r)
        victim = trainers[3]
        shares = victim.client.get_secagg_shares

        def die_after_shares(round_number):
            out = shares(round_number)
            if out[0]:
                victim._stop.set()
                raise RuntimeError("stopped after the share phase")
            return out

        victim.client.get_secagg_shares = die_after_shares
        ops.reset_launch_counts()
        wall = run_trainers(trainers, servicer, SECURE_ROUNDS + 1,
                            "secure deployment (b)")
        k3 = ops.launch_counts()["clip_noise"]
        gm = servicer.global_model
        survivors = [t.client_id for t in trainers if t is not victim]
        gap = rec.mean_gap(SECURE_ROUNDS, survivors)
        server.stop()
        servicer.persistence.repository.db.close()
        require(gm.participating_clients == survivors
                and victim.client_id not in rec.payloads[SECURE_ROUNDS]
                and gap <= grid and k3 == DEPLOY_CLIENTS
                and victim.rounds_completed == 0,
                f"secure deployment (b): participants "
                f"{gm.participating_clients}, gap {gap}, K3 {k3}")
        print(f"secure deployment (b) {victim.client_id} stopped after the "
              f"share phase: round {SECURE_ROUNDS} completed on "
              f"{len(survivors)} survivors (threshold "
              f"{DEPLOY_CLIENTS - 1}, its pair masks rebuilt from its "
              f"Shamir-shared key) in {wall:.2f}s; unmask "
              f"{1e3 * rec.unmasked[SECURE_ROUNDS][1]:.1f} ms; unmasked vs "
              f"the survivors' float64 mean {gap:.2e}; K3 launches {k3} "
              f"[{card}]", flush=True)
        k3_total = DEPLOY_CLIENTS * SECURE_ROUNDS + k3

        # (c) distributed DP
        ddp_pc = PrivacyConfig(DDP_BUDGET, SECURE_DELTA, max_grad_norm=1.0,
                               noise_multiplier=DDP_Z)
        servicer, server, port = secure_servicer(
            privacy_config=ddp_pc, distributed_dp=True, ddp_bits=DDP_BITS,
            secagg_threshold=DEPLOY_CLIENTS)
        trainers = secure_trainers(port, 1, ddp_pc, None, None,
                                   distributed_dp=True, ddp_bits=DDP_BITS)
        # the model the integer deltas apply to, served from round 0 on
        start = servicer.global_model = \
            servicer._create_initial_global_model()
        ops.reset_launch_counts()
        wall = run_trainers(trainers, servicer, 1,
                            "secure deployment (c)")
        got, none = _launched()
        gm = servicer.global_model
        server.stop()
        plan = rec.ddp[0][1]
        want_eps = distributed_epsilon(plan, 1, SECURE_DELTA,
                                       realized=DEPLOY_CLIENTS)
        charges = [[e["epsilon"] for e in
                    t.budget_tracker.consumption_history] for t in trainers]
        signal = sum(min(1.0, plan.clip_norm / np.linalg.norm(d)) * d
                     for d, _ in rec.ddp.values()) / plan.expected_clients
        avg = np.concatenate([
            to_numpy(gm.model_weights[k]).astype(np.float64).ravel()
            - to_numpy(start.model_weights[k]).astype(np.float64).ravel()
            for k in sorted(gm.model_weights)])
        sigma = plan.central_sigma_float(DEPLOY_CLIENTS)
        ratio = float((avg - signal).std() / sigma)
        require(none and len(rec.ddp) == DEPLOY_CLIENTS,
                f"secure deployment (c): launches {got}, "
                f"{len(rec.ddp)} integer payloads")
        require(all(c == [want_eps] for c in charges)
                and servicer.ddp_epsilon_total == want_eps
                and gm.accuracy_metrics["ddp_epsilon_total"] == want_eps,
                f"secure deployment (c): charges {charges}, total "
                f"{servicer.ddp_epsilon_total}, want {want_eps}")
        require(abs(ratio - 1.0) <= 0.05,
                f"secure deployment (c): noise std / sigma {ratio}")
        print(f"secure deployment (c) distributed DP ({DEPLOY_CLIENTS} "
              f"clients, z {DDP_Z}, {DDP_BITS} bits, gamma "
              f"{plan.gamma:.3e}): one round in {wall:.2f}s, no kernel "
              f"launched; each client charged eps {want_eps:.4f} at the "
              f"threshold, ddp_epsilon_total {servicer.ddp_epsilon_total:.4f}"
              f"; the decoded average's noise std / the plan's sigma "
              f"{sigma:.4f} = {ratio:.4f} [{card}]", flush=True)

        # (e) the command lines' services
        k3_total += secure_cli_services(card,
                                        os.path.join(model_dir, "cli"))
    finally:
        rec.restore()
        shutil.rmtree(model_dir, ignore_errors=True)
    counts["clip_noise"] = counts.get("clip_noise", 0) + k3_total
    print(f"secure deployment: K3 launches on the new paths {k3_total}; "
          f"phase {time.perf_counter() - t_phase:.1f}s [{card}]", flush=True)



# Oort selection on the bench round (phase_selection): the selector's
# docstring example, 64 of the 512 clients a round
SELECT_K = 64
SELECT_ROUNDS = 4           # after one unselected warm-up round


def phase_selection(card, counts):
    """``OortSelector(512, seed=0)`` picking 64 clients a round for the
    512-client ``"residual"`` bf16 delta-DP round: one warm-up round (all
    clients, not fed to the selector), then SELECT_ROUNDS rounds, each
    ``run_round(mask=sel.select_mask(64))`` and ``sel.update(mask,
    engine.last_client_losses, num_samples=...)``, one after another:
    round r+1's mask needs round r's losses. Each mask has 64 ones and the
    round 64 participants; the superstep still trains all 512 clients (the
    mask weights the mean), so K1/K2 launch 10 times a round and K3
    twice; the picks' losses are finite; the selector's state equals a
    second selector's fed the same losses on the host. The launches join
    ``counts``."""
    import numpy as np
    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.orchestration import OortSelector

    t_phase = time.perf_counter()
    engine = make_bench_engine("residual")
    num_samples = engine.data.num_samples.cpu().numpy()
    engine.run_round(evaluate=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sel = OortSelector(NUM_CLIENTS, seed=0)
    host = OortSelector(NUM_CLIENTS, seed=0)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    picks, losses = [], []
    for r in range(SELECT_ROUNDS):
        mask = sel.select_mask(SELECT_K)
        res = engine.run_round(mask=mask, evaluate=False)
        client_losses = engine.last_client_losses
        sel.update(mask, client_losses, num_samples=num_samples)
        want = host.select_mask(SELECT_K)
        host.update(want, np.array(client_losses), num_samples=num_samples)
        require(mask.sum() == SELECT_K and res.participating_clients
                == SELECT_K and np.array_equal(mask, want),
                f"selection round {r}: {int(mask.sum())} picks, "
                f"{res.participating_clients} participants, masks equal "
                f"{np.array_equal(mask, want)}")
        chosen = np.flatnonzero(mask)
        require(np.isfinite(client_losses[chosen]).all(),
                f"selection round {r}: non-finite losses at the picks")
        picks.append(chosen)
        losses.append(float(res.train_loss))
    dt = time.perf_counter() - t0
    got = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = LOCAL_EPOCHS * (SAMPLES_PER_CLIENT // BATCH_SIZE)
    want = dict.fromkeys(got, 0)
    want.update(conv_block_fwd=steps * SELECT_ROUNDS,
                conv_block_bwd=steps * SELECT_ROUNDS,
                clip_noise=2 * SELECT_ROUNDS)
    require(got == want, f"selection: launches {got}, expected {want}")
    state, ref = sel.state(), host.state()
    require(all(np.array_equal(state[k], ref[k]) for k in ref),
            "selection: the selector's state differs from the host "
            "selector fed the same losses")
    explored = int(state["explored"].sum())
    repeat = len(set(picks[-1]) & set(np.concatenate(picks[:-1])))
    for k in ("conv_block_fwd", "conv_block_bwd", "clip_noise"):
        counts[k] = counts.get(k, 0) + got[k]
    print(f"selection: OortSelector({NUM_CLIENTS}, seed=0) k={SELECT_K} on "
          f"the 'residual' bf16 delta-DP round, {SELECT_ROUNDS} selected "
          f"rounds in {dt:.3f}s -> {SELECT_ROUNDS / dt:.3f} rounds/s (one "
          f"device->host copy of the losses a round), peak memory "
          f"{peak:.2f} GiB, losses {[round(v, 4) for v in losses]}, "
          f"{explored} clients explored, {repeat} of the last round's picks "
          f"picked before, explore fraction "
          f"{float(state['explore_fraction']):.4f}; launches "
          f"{ {k: v for k, v in got.items() if v} } (0 elsewhere); state "
          f"equal to the host selector's; phase "
          f"{time.perf_counter() - t_phase:.1f}s [{card}]", flush=True)
    del engine
    torch.cuda.empty_cache()


# the experiment drivers at a cut size (phase_entry_experiments): argv, and
# the line the run must print
EXPERIMENT_CUTS = {
    "quick_start": ([], "4/5 checks passed"),
    "complete_system": ([], "12/13 checks passed"),
    "audit_privacy": (["--clients", "8", "--canaries", "8", "--rounds",
                       "2"], '"consistent"'),
    "adversarial_eval": (["--clients", "6", "--samples", "32", "--rounds",
                          "1", "--attackers", "1"], "wrote "),
    "inversion_demo": (["--steps", "20", "--restarts", "2"], "wrote "),
    "heterogeneity_comparison": (["--rounds", "1", "--clients", "6",
                                  "--samples", "32", "--local-epochs", "2"],
                                 "wrote "),
    "dp_ftrl_mnist": (["--clients", "32", "--cohort", "16", "--k", "1",
                       "--samples", "32", "--local-epochs", "1"],
                      '"mode": "dp_ftrl"'),
    "distributed_dp_parity": (["--clients", "16", "--samples", "64",
                               "--rounds", "1"], "wrote "),
    "peft_finetune": (["--clients", "4", "--samples", "32", "--rounds", "1",
                       "--pretrain-rounds", "1"], "wrote "),
    "dp_sgd_cifar_eps15": (["--clients", "2", "--samples-per-client", "512",
                            "--rounds", "1", "--accountant", "rdp"],
                           "FINAL accuracy="),
    "dp_sgd_mnist_eps1": (["--clients", "4", "--samples-per-client", "512",
                           "--rounds", "1", "--accountant", "rdp"],
                          "FINAL accuracy="),
}
# the drivers whose path releases through K3 (DP-SGD's noise, the inversion
# report's DP release)
EXPERIMENT_K3 = ("inversion_demo", "dp_sgd_cifar_eps15", "dp_sgd_mnist_eps1")


def phase_entry_experiments(card, counts):
    """The entry points and the experiment drivers on the card:
    ``entry()``'s forward against the same forward on the CPU (f32, TF32
    off, within 1e-5); ``dryrun_multichip(2)`` (two gloo ranks sharing the
    card, as the one-card machine has no second one for NCCL) with K3
    launched on each rank; then every driver of
    ``fl_tpu_torch.experiments`` once through its ``main`` at a cut size
    (EXPERIMENT_CUTS), each timed, its closing line and its record's
    platform (the card) checked. K3's launches join ``counts``."""
    import contextlib
    import importlib
    import io
    import shutil

    import torch

    from fl_tpu_torch import ops
    from fl_tpu_torch.core.pytree import tree_map
    from fl_tpu_torch.entry import dryrun_multichip, entry

    t_phase = time.perf_counter()
    forward, (variables, x) = entry()
    gen = torch.Generator(device="cuda").manual_seed(5)
    xs = torch.randn(x.shape, generator=gen, device="cuda")
    cpu_vars = tree_map(lambda t: t.cpu(), variables)
    gaps = []
    for xin in (x, xs):
        got = forward(variables, xin)
        want = forward(cpu_vars, xin.cpu())
        require(tuple(got.shape) == (32, 10)
                and bool(torch.isfinite(got).all()),
                f"entry: forward shape {tuple(got.shape)}")
        gaps.append(float((got.cpu() - want).abs().max()))
    require(max(gaps) <= 1e-5, f"entry: card vs CPU forward {gaps}")
    t0 = time.perf_counter()
    ranks = dryrun_multichip(2)
    dry_s = time.perf_counter() - t0
    k3 = [r["launches"].get("clip_noise", 0) for r in ranks]
    require(all(v > 0 and set(r["launches"]) == {"clip_noise"}
                for v, r in zip(k3, ranks)),
            f"dryrun_multichip(2): launches by rank "
            f"{[r['launches'] for r in ranks]}")
    print(f"entry: SimpleCNN forward on the card vs the CPU, largest gap "
          f"{max(gaps):.2e} (zeros and N(0, 1) images); dryrun_multichip(2) "
          f"on 2 gloo ranks sharing the card in {dry_s:.1f}s, loss "
          f"{ranks[0]['train_loss']:.4f}, K3 by rank {k3} [{card}]",
          flush=True)
    k3_total = sum(k3)

    out_dir = tempfile.mkdtemp(prefix="fl_experiments_")
    times = {}
    try:
        for name, (argv, line) in EXPERIMENT_CUTS.items():
            mod = importlib.import_module(f"fl_tpu_torch.experiments.{name}")
            out = os.path.join(out_dir, f"{name}.json")
            has_out = any(a.dest == "out"
                          for a in mod.build_parser()._actions)
            args = argv + (["--out", out] if has_out else [])
            buf = io.StringIO()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(buf):
                rc = mod.main(args)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            text = buf.getvalue()
            launched = {k: v for k, v in ops.launch_counts().items() if v}
            require(line in text, f"experiment {name}: no {line!r} in "
                                  f"{text[-600:]!r}")
            require(rc in (0, 1), f"experiment {name}: exit code {rc}")
            if has_out:
                with open(out) as f:
                    record = json.load(f)
                require(torch.cuda.get_device_name(0) in record["platform"],
                        f"experiment {name}: record platform "
                        f"{record['platform']!r}")
            if name in EXPERIMENT_K3:
                require(launched.get("clip_noise", 0) > 0,
                        f"experiment {name}: K3 not launched ({launched})")
            k3_total += launched.get("clip_noise", 0)
            last = [ln for ln in text.splitlines() if ln.strip()][-1]
            print(f"experiment {name} {' '.join(args[:len(argv)])}: rc {rc}"
                  f", {times[name]:.1f}s, launches {launched}; last line "
                  f"{last[:160]!r} [{card}]", flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    counts["clip_noise"] = counts.get("clip_noise", 0) + k3_total
    print(f"entry + experiments: K3 launches {k3_total}; drivers "
          f"{sum(times.values()):.1f}s; phase "
          f"{time.perf_counter() - t_phase:.1f}s [{card}]", flush=True)


def kernel_report():
    src_cu = "fl_tpu_torch/csrc/conv_block.cu"
    rows = (
        ("conv_block_fwd", "cuda", src_cu, "fl_tpu/ops/conv_block.py:649"),
        ("conv_block_bwd", "cuda", src_cu, "fl_tpu/ops/conv_block.py:689"),
        ("clip_noise", "triton", "fl_tpu_torch/ops/dp.py",
         "fl_tpu/ops/dp.py:51"),
        ("conv_stack_fwd", "cuda", src_cu, "fl_tpu/ops/conv_block.py:316"),
        ("conv_stack_bwd", "cuda", src_cu, "fl_tpu/ops/conv_block.py:357"),
        ("conv_stack_packed", "cuda", src_cu,
         "fl_tpu/ops/conv_block.py:1256"),
        ("quantize_int8_blocks", "triton", "fl_tpu_torch/ops/quantize.py",
         "fl_tpu/ops/quantize.py:72"),
        ("conv3x3_patch_gemm", "cuda", "fl_tpu_torch/csrc/conv_patch.cu",
         "fl_tpu/ops/conv_pallas.py:86"),
        ("conv3x3_patch_wgrad", "cuda", "fl_tpu_torch/csrc/conv_patch.cu",
         "fl_tpu/ops/conv_pallas.py:86"),
        ("probe_batched_gemm", "cuda", "fl_tpu_torch/csrc/conv_probe.cu",
         "scripts/probe_pallas_pipelined.py:37"),
        ("probe_taploop_conv", "cuda", "fl_tpu_torch/csrc/conv_probe.cu",
         "scripts/probe_pallas_pipelined.py:62"),
    )
    return {name: {"name": name, "route": route, "source": source,
                   "replaces": replaces}
            for name, route, source, replaces in rows}


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
    t_start = time.perf_counter()

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
    report = kernel_report()
    phase_conv(report)
    phase_dp(report)
    phase_quantize(report)
    phase_conv_patch(report)
    phase_conv_probe(report)
    print("times (ms, kernel/plain/bound): " + ", ".join(
        f"{k} {v['ms']:.3f}/{v['plain_ms']:.3f}/{v['bound_ms']:.3f}"
        for k, v in report.items()) + "; bound with the conv2 gradient "
          "products counted dense: " + ", ".join(
        f"{k} {v['dense_ms']:.3f}" for k, v in report.items()
        if "dense_ms" in v), flush=True)

    # 4. the first slice's path; 5. this slice's paths
    counts = {}
    paths = (("residual", 3, ("conv_block_fwd", "conv_block_bwd")),
             (True, 3, ("conv_stack_fwd", "conv_stack_bwd")),
             (False, 2, ()))
    check_pool_first_match()
    for fused, rounds, conv_counts in paths:
        got, _, _ = bench_engine(card, fused, rounds, conv_counts)
        counts.update({k: got[k] for k in conv_counts})
        if fused == "residual":
            counts["clip_noise"] = got["clip_noise"]
    # 5b. the compressed rounds, the uplink ops and the wire codecs
    phase_compression(card)
    entry_points(counts)
    # 5c. client-level DP-FedAvg
    phase_central_dp(card)

    # 5d. the local-training options and the first server-side features
    phase_fl_variants(card)
    # 5e. the server side's second half and the engine's other entry points
    phase_engine_api(card, counts, report)

    # 5f. DP-SGD, DP-FTRL and distributed DP
    phase_dp_mechanisms(card, report)

    # 5g. CIFAR-10: CIFAR10CNN with per-client batch statistics, the
    # augmentation, K3 at five groups; DP-SGD ghost on GroupNorm
    phase_cifar(card)
    # 5h. the rest of the model zoo: the ResNet (the cifar100 route), the
    # ViT with LoRA, the MobileNet; K3 at their groups
    phase_zoo(card)

    # 5i. the client axis sharded over ranks, with evaluate_personalized and
    # profile_round on the ranks
    for k, v in phase_mesh(card).items():
        counts[k] = counts.get(k, 0) + v
    # 5j. the clustered (IFCA), Ditto and async (FedBuff) engines
    phase_engines(card, counts)
    # 5k. the hierarchical, decentralized, FedDF and HPO engines
    phase_topologies(card, counts, report)
    # 5l. the simulation entry point, the validators and attacks, federated
    # analytics and vertical FL
    phase_validation(card, counts)
    # 5m. the deployment round: the client FSM, the round manager and the
    # host FedAvg on the card, K3 in each client's release
    phase_deployment(card, counts)
    # 5n. the secure deployment: Bonawitz masking with K3 in each masked
    # client, dropout recovery, distributed DP, restart, the command lines
    phase_secure_deployment(card, counts)
    # 5o. Oort selection on the bench round; the entry points and the
    # experiment drivers
    phase_selection(card, counts)
    phase_entry_experiments(card, counts)

    # 6. learning checks
    learning_check("residual")
    learning_check(True)
    learning_check("residual", "scaffold (sgd lr 0.05)",
                   dict(scaffold=True), optimizer_type="sgd", momentum=0.0,
                   learning_rate=0.05)
    learning_check("residual", "fednova (sgd lr 0.05 momentum 0.9, epochs "
                   "1 + (i mod 3) of 3)", dict(fednova=True),
                   budgets=[1 + i % 3 for i in range(10)], local_epochs=3,
                   optimizer_type="sgd", momentum=0.9, learning_rate=0.05)
    learning_check("residual", f"feddyn alpha={FEDDYN_ALPHA}",
                   dict(feddyn_alpha=FEDDYN_ALPHA))
    qffl_learning_check()
    mechanism_learning_checks()

    # 7. the conv formulations at full width
    from fl_tpu_torch import ops

    ops.reset_launch_counts()
    _, got = conv_formulations(card)
    counts.update(got)

    # 8. result lines
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    for k, entry in report.items():
        entry["launches"] = counts[k]
        require(entry["launches"] > 0, f"{k} was never launched on its path")
    print(f"smoke: {time.perf_counter() - t_start:.1f}s in all", flush=True)
    # the fused conv kernels also name the instruction of their bf16 route
    print(json.dumps({"kernels": [
        {k: e[k] for k in order + ("instruction",) if k in e}
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
