"""The plain federated round that every configuration's reference runs:
local training of each client from the global model, the DP release and
the sample-weighted FedAvg, in float32 PyTorch with TF32 off.

It reads the workload's fields by their engine names and works out again
every stream the measured program derives from the engine seed (the
shuffle, dropout, augmentation and DP noise; ``lib/prng.py``,
``lib/philox.py``), so that it trains each client on the same batches,
under the same dropout masks and augmentation, and draws the same noise.
It imports nothing of the program.

A model reference module supplies ``forward(params, x, keep, q, stats)``
-> (logits, new stats or None), ``dropout_keep(C, B, generator, device)``
-> the keep masks in the model's draw order, and, for DP-SGD,
``forward_taps`` and ``PER_EXAMPLE``.

``precision`` "float8" is the control: every value that the
configuration holds in its bfloat16 compute dtype (the inputs, weights
and outputs of each convolution and product, a normalization's output)
rounded to float8 e4m3 instead, each tensor scaled by its absolute
maximum, and every gradient flowing back through such a rounding to
float8 e5m2. ``q`` is that rounding (the identity in float32).
``faults`` plants the faults the check must catch: "unchanged" (the round
returns the global model it was given), "half_clients" (the mean over the
first half of the clients only), "half_batch" (each local step on the
first half of its batch).
"""

from __future__ import annotations

import contextlib
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Sequence

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lib import philox, prng  # noqa: E402

# leaves of at least this many elements a client get a noise group of
# their own, the others share one (the release's documented grouping)
STANDALONE_MIN = 1 << 16
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fq(t: torch.Tensor, dtype) -> torch.Tensor:
    amax = t.detach().abs().amax().clamp(min=1e-30)
    s = amax / torch.finfo(dtype).max
    return (t / s).to(dtype).to(torch.float32) * s


class _Float8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _fq(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fq(g, torch.float8_e5m2)


def quantizer(precision: str):
    if precision == "float32":
        return lambda t: t
    if precision == "float8":
        return _Float8.apply
    raise ValueError(f"precision {precision!r}")


# -- tree helpers (sorted keys at every depth) ------------------------------

def paths(tree) -> List[tuple]:
    out: List[tuple] = []

    def rec(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(prefix + (k,), node[k])
        else:
            out.append(prefix)
    rec((), tree)
    return out


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def build(path_list, leaves) -> Dict:
    out: Dict = {}
    for path, leaf in zip(path_list, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tmap(fn, *trees):
    ps = paths(trees[0])
    return build(ps, [fn(*(get(t, p) for t in trees)) for p in ps])


# -- local training ----------------------------------------------------------

def per_example_losses(logits, labels):
    C, B, K = logits.shape
    return F.cross_entropy(logits.reshape(C * B, K), labels.reshape(C * B),
                           reduction="none").reshape(C, B)


def crop_flip(xb, dy, dx, flip, padding=4):
    C, B, H, W, _ = xb.shape
    dev = xb.device
    padded = F.pad(xb, (0, 0, padding, padding, padding, padding))
    rows = dy.reshape(C, 1, 1, 1) + torch.arange(H, device=dev).reshape(
        1, 1, H, 1)
    cols = torch.arange(W, device=dev).reshape(1, 1, 1, W)
    cols = torch.where(flip.reshape(C, B, 1, 1), W - 1 - cols, cols)
    cols = dx.reshape(C, 1, 1, 1) + cols
    ci = torch.arange(C, device=dev).reshape(C, 1, 1, 1)
    bi = torch.arange(B, device=dev).reshape(1, B, 1, 1)
    return padded[ci, bi, rows, cols]


class Plan:
    """The round's fixed quantities, read from the workload."""

    def __init__(self, workload: Dict[str, Any], config: Dict[str, Any],
                 clients: int, per_client: int):
        t = workload["training"]
        e = workload["engine"]
        p = workload["privacy"]
        self.C, self.N = clients, per_client
        self.B = t["batch_size"]
        self.steps = max(1, per_client // self.B)
        self.epochs = t["local_epochs"]
        self.lr = t["learning_rate"]
        self.opt = t.get("optimizer_type", "adam")
        self.momentum = t.get("momentum", 0.9)
        self.dp_mode = e["dp_mode"]
        self.clip = p["max_grad_norm"]
        self.z = p.get("noise_multiplier", 1.0)
        eps_r = e.get("epsilon_per_round") or p["epsilon"]
        del_r = e.get("delta_per_round") or p["delta"]
        self.gauss = math.sqrt(2.0 * math.log(1.25 / del_r)) / eps_r
        self.augment = bool(workload.get("augment"))
        norm = config["normalize"]
        self.mean = norm["mean"]
        self.std = norm["std"]


def local_train(model, plan: Plan, variables, images, labels, rseed: int,
                q, faults: Sequence[str]):
    """Every client of the round from the unstacked ``variables``:
    returns (their trained variables stacked, their last epoch's mean
    losses, the squared norm of each parameter leaf's first gradient)."""
    dev = images.device
    C = plan.C
    B, steps = plan.B, plan.steps
    mean = torch.tensor(plan.mean, device=dev)
    std = torch.tensor(plan.std, device=dev)
    ps = paths(variables["params"])
    p = [get(variables["params"], k)[None].expand(
        (C,) + get(variables["params"], k).shape).clone().requires_grad_(True)
        for k in ps]
    stats = (tmap(lambda v: v[None].expand((C,) + v.shape).clone(),
                  variables["batch_stats"])
             if "batch_stats" in variables else None)
    slots = [[torch.zeros_like(x) for x in p] for _ in range(2)]
    shuffle = prng.fold(rseed, prng.SHUFFLE)
    dropout = prng.fold(rseed, prng.DROPOUT)
    noise = prng.fold(rseed, prng.DP_NOISE)
    augment = prng.fold(rseed, prng.AUGMENT)
    row_idx = torch.arange(C, device=dev)[:, None]
    count = 0
    for epoch in range(plan.epochs):
        g = prng.torch_generator(prng.fold(shuffle, epoch), dev)
        perm = torch.argsort(torch.rand((plan.C, plan.N), generator=g,
                                        device=dev), dim=1)
        ep_loss = torch.zeros(C, device=dev)
        for step in range(steps):
            ctr = epoch * steps + step
            idx = perm[:, step * B:(step + 1) * B]
            xb = (images[row_idx, idx].float() / 255.0 - mean) / std
            yb = labels[row_idx, idx]
            if plan.augment:
                ga = prng.torch_generator(prng.fold(augment, ctr), dev)
                off = torch.randint(0, 9, (2, plan.C), generator=ga,
                                    device=dev)
                flip = torch.rand((plan.C, B), generator=ga,
                                  device=dev) < 0.5
                xb = crop_flip(xb, off[0], off[1], flip)
            keep = model.dropout_keep(
                plan.C, B, prng.torch_generator(prng.fold(dropout, ctr),
                                                dev), dev)
            if "half_batch" in faults:
                h = B // 2
                xb, yb = xb[:, :h], yb[:, :h]
                keep = tmap(lambda k: k[:, :h], keep) if isinstance(
                    keep, dict) else (None if keep is None else keep[:, :h])
            params = build(ps, p)
            if plan.dp_mode == "dp_sgd":
                grads, loss = dp_sgd_grads(model, plan, params, ps, xb, yb,
                                           keep, q, prng.fold(noise, ctr))
            else:
                logits, new = model.forward(params, xb, keep, q, stats)
                loss = per_example_losses(logits, yb).mean(1)
                grads = list(torch.autograd.grad(loss.sum(), p))
                if new is not None:
                    stats = new
            if count == 0:
                first_sq = {("params",) + k: float(g.double().square().sum())
                            for k, g in zip(ps, grads)}
            count += 1
            with torch.no_grad():
                if plan.opt == "adam":
                    c1 = 1.0 - ADAM_B1 ** count
                    c2 = 1.0 - ADAM_B2 ** count
                    for i, gr in enumerate(grads):
                        m, v = slots[0][i], slots[1][i]
                        m.mul_(ADAM_B1).add_((1 - ADAM_B1) * gr)
                        v.mul_(ADAM_B2).add_((1 - ADAM_B2) * gr * gr)
                        p[i].sub_(plan.lr * (m / c1)
                                  / (torch.sqrt(v / c2) + ADAM_EPS))
                else:
                    for i, gr in enumerate(grads):
                        t = slots[0][i]
                        t.mul_(plan.momentum).add_(gr)
                        p[i].sub_(plan.lr * t)
            ep_loss += loss.detach()
        losses = ep_loss / steps
    out = {"params": build(ps, [x.detach() for x in p])}
    if stats is not None:
        out["batch_stats"] = tmap(lambda v: v.detach(), stats)
    return out, losses, first_sq


def dp_sgd_grads(model, plan: Plan, params, ps, xb, yb, keep, q,
                 step_seed: int):
    """Each example's gradient clipped to C (norms from the explicit
    per-example gradients), the sum over the batch divided by B, plus
    N(0, (z·C/B)²) for every element, leaf i of client c keyed by
    fold(fold(step seed, i), c). Returns (the noisy gradients, each
    client's mean loss of the step)."""
    C, B = yb.shape
    leaves = [get(params, k).detach().requires_grad_(True) for k in ps]
    params = build(ps, leaves)
    logits, taps = model.forward_taps(params, xb, keep, q)
    losses = per_example_losses(logits, yb)
    outs = [t[2] for t in taps]
    dys = torch.autograd.grad(losses.sum(), outs, retain_graph=True)
    sq = torch.zeros(C * B, device=xb.device)
    for (kind, a, _), dy in zip(taps, dys):
        sq += model.PER_EXAMPLE[kind](a.detach(), dy.detach(), C, B)
    del dys, taps, outs
    scale = torch.clamp(plan.clip / torch.clamp(torch.sqrt(sq), min=1e-12),
                        max=1.0).reshape(C, B)
    # the clipped sum: the backward of the losses weighted by the scales
    grads = torch.autograd.grad(losses, leaves, grad_outputs=scale)
    sigma = plan.z * plan.clip / B
    out = []
    for i, gr in enumerate(grads):
        seeds = prng.client_seeds_of(prng.fold(step_seed, i), plan.C)
        z = philox.normals(seeds, gr[0].numel(), gr.device)
        out.append(gr / B + sigma * z.reshape(gr.shape))
    return out, losses.detach().mean(1)


# -- the release and the aggregate -------------------------------------------

def leaf_groups(tree) -> List[List[tuple]]:
    ps = paths(tree)
    big = [[k] for k in ps if get(tree, k)[0].numel() >= STANDALONE_MIN]
    small = [k for k in ps if [k] not in big]
    return big + ([small] if small else [])


def delta_release(plan: Plan, deltas, rseed: int):
    """Each client's delta clipped to C over the whole variables tree and
    N(0, σ²) added, σ = min(‖Δ‖, C)·√(2 ln(1.25/δ))/ε; the noise of leaf
    group g of client c keyed by fold(fold(fold(round, c), DP_NOISE), g).
    Returns (released deltas, their noise)."""
    ps = paths(deltas)
    norms = torch.sqrt(sum(get(deltas, k).reshape(
        get(deltas, k).shape[0], -1).square().sum(1) for k in ps))
    scale = torch.clamp(plan.clip / torch.clamp(norms, min=1e-12), max=1.0)
    sigma = torch.clamp(norms, max=plan.clip) * plan.gauss
    noise = {}
    for gi, group in enumerate(leaf_groups(deltas)):
        seeds = prng.client_stream_seeds(rseed, plan.C, prng.DP_NOISE, gi)
        widths = [get(deltas, k)[0].numel() for k in group]
        z = philox.normals(seeds, sum(widths), norms.device)
        for k, part in zip(group, torch.split(z, widths, 1)):
            noise[k] = (sigma[:, None] * part).reshape(get(deltas, k).shape)
    released = build(ps, [get(deltas, k) * scale.reshape(
        (-1,) + (1,) * (get(deltas, k).dim() - 1)) + noise[k] for k in ps])
    return released, build(ps, [noise[k] for k in ps])


def run_round(model, plan: Plan, variables, images, labels, rseed: int,
              q, faults: Sequence[str]):
    """One round: returns (new global variables, the per-client losses, the
    release's noise in the mean, or None without a round-level release,
    the norm of each parameter leaf's first gradient over all clients)."""
    C = plan.C
    weights = torch.full((C,), 1.0 / C, device=images.device)
    if "half_clients" in faults:
        weights[C // 2:] = 0.0
        weights *= 2.0
    trained, losses, grad_sq = local_train(model, plan, variables, images,
                                           labels, rseed, q, faults)
    deltas = tmap(lambda n, g: n - g[None], trained, variables)
    del trained
    noise = noise_mean = None
    if plan.dp_mode == "delta":
        deltas, noise = delta_release(plan, deltas, rseed)
        noise_mean = tmap(lambda d: torch.tensordot(weights, d, dims=1),
                          noise)
    update = tmap(lambda d: torch.tensordot(weights, d, dims=1), deltas)
    del deltas, noise
    if "unchanged" in faults:
        new = tmap(lambda g: g.clone(), variables)
    else:
        new = tmap(torch.add, variables, update)
    grad_norms = {k: math.sqrt(v) for k, v in grad_sq.items()}
    return new, losses, noise_mean, grad_norms


def run(model, workload: Dict[str, Any], config: Dict[str, Any], variables,
        images, labels, engine_seed: int, rounds: int,
        precision: str = "float32", faults: Sequence[str] = ()):
    """``rounds`` rounds from ``variables``, each from the last one's
    result. Returns one record a round: {"variables", "client_losses",
    "loss", "noise", "grad_norms"} (the loss the clients' sample-weighted
    mean; the norm of each parameter leaf's first local gradient over all
    clients, keyed by its path in the variables tree)."""
    C, N = labels.shape
    plan = Plan(workload, config, C, N)
    q = quantizer(precision)
    root = prng.root_seed(engine_seed)
    out = []
    with tf32_off():
        for r in range(rounds):
            variables, losses, noise, grad_norms = run_round(
                model, plan, variables, images, labels, prng.fold(root, r),
                q, faults)
            out.append({"variables": variables,
                        "client_losses": losses.double().cpu().numpy(),
                        "loss": float(losses.double().mean()),
                        "noise": noise, "grad_norms": grad_norms})
    return out


def stack_planes(t: torch.Tensor) -> torch.Tensor:
    """(C, B, H, W, K) -> (B, C·K, H, W)."""
    C, B, H, W, K = t.shape
    return t.permute(1, 0, 4, 2, 3).reshape(B, C * K, H, W)


def unstack_planes(h: torch.Tensor, C: int) -> torch.Tensor:
    """(B, C·K, H, W) -> (C, B, H, W, K)."""
    B, CK, H, W = h.shape
    return h.reshape(B, C, CK // C, H, W).permute(1, 0, 3, 4, 2)


def grouped_conv(h, kernel, q, C: int):
    """A SAME 3x3 convolution of each client's planes with its own HWIO
    kernel (C, 3, 3, I, O)."""
    w = q(kernel).permute(0, 4, 3, 1, 2).reshape(-1, kernel.shape[3], 3, 3)
    return q(F.conv2d(q(h), w, padding=1, groups=C))


def conv_sq(a: torch.Tensor, dy: torch.Tensor, C: int, B: int,
            chunk: int = 4096) -> torch.Tensor:
    """(C·B,) squared norms of each example's 3x3 SAME conv kernel and bias
    gradient, from its input planes a (B, C·I, H, W) and output gradient
    dy (B, C·O, H, W): the kernel gradient written out, dy · unfold(a)."""
    Bh, CI, H, W = a.shape
    ex_a = a.reshape(B, C, CI // C, H, W).transpose(0, 1).reshape(
        C * B, CI // C, H, W)
    ex_dy = dy.reshape(B, C, -1, H, W).transpose(0, 1).reshape(
        C * B, -1, H * W)
    out = []
    for i in range(0, C * B, chunk):
        cols = F.unfold(ex_a[i:i + chunk], 3, padding=1)  # (n, 9I, HW)
        d = ex_dy[i:i + chunk]
        g = torch.bmm(d, cols.transpose(1, 2))
        out.append(g.square().sum((1, 2)) + d.sum(2).square().sum(1))
    return torch.cat(out)


def dense_sq(a: torch.Tensor, dy: torch.Tensor, C: int, B: int
             ) -> torch.Tensor:
    """(C·B,) squared norms of each example's dense kernel and bias
    gradient: ‖a‖²·‖dy‖² + ‖dy‖² (the kernel gradient is an outer
    product)."""
    d2 = dy.reshape(C * B, -1).square().sum(1)
    return a.reshape(C * B, -1).square().sum(1) * d2 + d2


PER_EXAMPLE = {"conv": conv_sq, "dense": dense_sq}
