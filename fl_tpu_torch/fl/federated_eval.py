"""Federated evaluation: the global model scored on every client's own
shard (port of ``fl_tpu.fl.federated_eval``).

One program over the stacked client axis: eval-mode forward passes over
every padded client shard, masked to the valid samples and chunked (each
chunk one forward over all C clients at once, so a fused model launches
its conv kernel once a chunk), no autograd; per-client loss and accuracy
plus the sample-weighted population aggregate. The round engine also uses
it for q-FFL's F_k(θ̂), the clients' losses at the model they received.
A BatchNorm model is scored with its running statistics.

Under a client mesh each rank scores its own rows, and the per-client
results come back in global order through one all-reduce (each rank's
rows at their offset of a zeroed (C,) vector): the aggregate and the
spread are then those of the single-process evaluation.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from fl_tpu_torch.core.pytree import tree_map
from fl_tpu_torch.fl.local_training import model_kwargs


def make_federated_eval_fn(model, samples_per_client: int, mean, std,
                           chunk_size: int = 256) -> Callable:
    """Build ``fn(params, images_u8, labels, n_valid, batch_stats=None)
    -> metrics`` over the stacked client axis: ``params`` a tree of (C,
    ...) leaves (an expanded view of one model serves), ``images_u8`` (C,
    N, H, W, ch), ``labels`` (C, N), ``n_valid`` (C,), ``batch_stats`` the
    (C, ...) running statistics of a BatchNorm model; metrics (C,)
    ``loss`` / ``accuracy`` (means over the valid samples) and ``n`` (the
    valid count)."""
    N = samples_per_client
    chunk = min(chunk_size, N)
    n_chunks = -(-N // chunk)
    pad_to = n_chunks * chunk

    @torch.no_grad()
    def evaluate(params, images_u8, labels, n_valid, batch_stats=None
                 ) -> Dict[str, torch.Tensor]:
        C = images_u8.shape[0]
        n = n_valid.to(torch.int32)
        if pad_to != N:
            images_u8 = F.pad(images_u8, (0, 0) * (images_u8.dim() - 2)
                              + (0, pad_to - N))
            labels = F.pad(labels, (0, pad_to - N))
        m = torch.as_tensor(mean, dtype=torch.float32,
                            device=images_u8.device)
        s = torch.as_tensor(std, dtype=torch.float32, device=images_u8.device)
        loss_sum = torch.zeros(C, device=images_u8.device)
        correct_sum = torch.zeros(C, device=images_u8.device)
        pos0 = torch.arange(chunk, device=images_u8.device)
        for ci in range(n_chunks):
            xb = images_u8[:, ci * chunk:(ci + 1) * chunk]
            yb = labels[:, ci * chunk:(ci + 1) * chunk].long()
            x = (xb.float() / 255.0 - m) / s
            logits = model(params, x, train=False,
                           **model_kwargs(batch_stats))
            msk = ((ci * chunk + pos0)[None, :] < n[:, None]).float()
            per = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  yb.reshape(-1), reduction="none"
                                  ).reshape(yb.shape)
            loss_sum = loss_sum + (per * msk).sum(1)
            correct_sum = correct_sum + (
                (logits.argmax(-1) == yb).float() * msk).sum(1)
        denom = torch.clamp(n.float(), min=1.0)
        return {"loss": loss_sum / denom, "accuracy": correct_sum / denom,
                "n": n}

    return evaluate


def gather_scores(engine, out: Dict[str, torch.Tensor],
                  count: str = "n") -> Dict[str, np.ndarray]:
    """An evaluation's (CL,) per-client metrics of this rank's rows (a
    federated evaluation's ``loss`` / ``accuracy`` / ``n``, the
    personalization's five) as (C,) host arrays in global order: one
    all-reduce of them packed under a mesh (the engine's client axis), a
    copy without one. ``count`` names the integer one."""
    if engine.mesh is None:
        return {k: v.cpu().numpy() for k, v in out.items()}
    keys = list(out)
    packed = engine._axis.psum(torch.stack(
        [engine._axis.per_client(out[k].float()) for k in keys])).cpu().numpy()
    got = dict(zip(keys, packed))
    got[count] = got[count].astype(np.int32)
    return got


def evaluate_federated(engine) -> Dict[str, object]:
    """Score a FederatedRoundEngine's current global model on every
    client's own shard. Returns per-client arrays plus the sample-weighted
    mean and the accuracy spread (the fairness signal)."""
    run = make_federated_eval_fn(
        engine.model, samples_per_client=engine.data.samples_per_client,
        mean=engine.data.mean, std=engine.data.std)
    rows = engine.data.images.shape[0]  # CL under a mesh
    stacked = tree_map(lambda v: v[None].expand(rows, *v.shape),
                       engine.global_variables)
    out = gather_scores(engine, run(
        stacked["params"], engine.data.images, engine.data.labels,
        engine.data.num_samples, stacked.get("batch_stats")))
    w = out["n"].astype(np.float64)
    w = w / max(w.sum(), 1.0)
    return {
        "per_client": out,
        "loss": float((out["loss"] * w).sum()),
        "accuracy": float((out["accuracy"] * w).sum()),
        "accuracy_min": float(out["accuracy"].min()),
        "accuracy_max": float(out["accuracy"].max()),
        "accuracy_std": float(out["accuracy"].std()),
    }
