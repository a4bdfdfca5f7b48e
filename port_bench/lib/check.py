"""The comparison that decides ``correct``.

Set-up drives the engine from the seed through its first rounds with the
window's own call and keeps what each returned: the round's loss, every
client's loss, and the global model. The plain reference follows those
rounds from the same inputs. The numbers compared:

- ``loss_gap``: the worst round's |loss − reference| / |reference|, the
  loss the clients' sample-weighted mean of their last local epoch;
- ``client_loss_gap``: the same for the worst single client and round;
- ``update_gap``: the first round's update θ1 − θ0 against the
  reference's, by the worst leaf: |‖u‖ − ‖u_ref‖| over the larger of
  ‖u_ref‖ and the median leaf's ‖u_ref‖;
- ``change_gap``: the same of the change after the last round followed.

Where the release adds noise at the round (delta DP), the noise that the
reference draws, which is the program's stream, is taken off both
updates first: at ε_r = 1/28 it is 150 times the clipped deltas, and the
gap would otherwise say nothing of training, clipping or the mean.
Parameter leaves whose first reference gradient is under a thousandth of
the median leaf's are left out of the leaf gaps: Adam moves them by
round-off alone (a convolution's bias right before a BatchNorm).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Set

import numpy as np
import torch

NAMES = ("loss_gap", "client_loss_gap", "update_gap", "change_gap")
NEGLIGIBLE = 1e-3


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def rounding_leaves(grad_norms: Dict[tuple, float]) -> Set[tuple]:
    """The parameter leaves whose first reference gradient is under a
    thousandth of the median leaf's: nought to rounding (a bias right
    before a BatchNorm), so that Adam moves them by round-off alone."""
    med = float(np.median(list(grad_norms.values())))
    return {p for p, n in grad_norms.items() if n < NEGLIGIBLE * med}


def leaf_gaps(prog: Dict[str, Any], ref: Dict[str, Any],
              skip: Set[tuple] = frozenset()) -> Dict[str, float]:
    """Each leaf's |‖prog‖ − ‖ref‖| over the larger of ‖ref‖ and the
    median leaf's ‖ref‖, by "/"-joined path."""
    norms = {p: float(t.double().norm()) for p, t in _leaves(prog)}
    ref_norms = {p: float(t.double().norm()) for p, t in _leaves(ref)
                 if p not in skip}
    med = float(np.median(list(ref_norms.values())))
    return {"/".join(p): abs(norms[p] - r) / max(r, med)
            for p, r in ref_norms.items()}


def _minus(a, b):
    if isinstance(a, dict):
        return {k: _minus(a[k], b[k]) for k in a}
    return a.double() - b.double()


def _plus(a, b):
    if isinstance(a, dict):
        return {k: _plus(a[k], b[k]) for k in a}
    return a.double() + b.double()


def readings(theta0, program: Sequence[Dict[str, Any]],
             reference: Sequence[Dict[str, Any]]) -> Dict[str, float]:
    """``program`` and ``reference``: one record a round followed, each
    with "variables", "client_losses" and "loss"; the reference's also
    "noise" (its noise in the mean, or None)."""
    rounds = len(reference)
    loss_gap = max(abs(p["loss"] - r["loss"]) / abs(r["loss"])
                   for p, r in zip(program, reference))
    client_gap = max(float(np.max(np.abs(p["client_losses"]
                                         - r["client_losses"])
                                  / np.abs(r["client_losses"])))
                     for p, r in zip(program, reference))
    noise: List[Any] = []
    for r in reference:
        if r["noise"] is not None:
            noise.append(r["noise"] if not noise
                         else _plus(noise[-1], r["noise"]))

    def update(rec, k):
        u = _minus(rec["variables"], theta0)
        return _minus(u, noise[k]) if noise else u

    skip = rounding_leaves(reference[0]["grad_norms"])
    first = leaf_gaps(update(program[0], 0), update(reference[0], 0), skip)
    last = leaf_gaps(update(program[rounds - 1], rounds - 1),
                     update(reference[rounds - 1], rounds - 1), skip)
    return {
        "loss_gap": loss_gap,
        "client_loss_gap": client_gap,
        "update_gap": max(first.values()),
        "change_gap": max(last.values()),
        "leaves": {"update": first, "change": last},
    }


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every compared number is finite and within its limit;
    false where no limit is set."""
    if not limits:
        return False
    return all(math.isfinite(values[k]) and values[k] <= lim
               for k, lim in limits.items())


def to_host(tree):
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float64)


def host_records(records):
    """Round records with their trees copied to the host in float64."""
    out = []
    for r in records:
        r = dict(r, variables=to_host(r["variables"]))
        if r.get("noise") is not None:
            r["noise"] = to_host(r["noise"])
        out.append(r)
    return out
