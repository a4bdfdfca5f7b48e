"""Checkpoint and resume of the round engine (port of
``fl_tpu.orchestration.checkpoint``).

The reference's layout, with ``torch.save`` in place of orbax: one
directory a checkpoint, ``round_{step:08d}/``, holding ``variables.pt``
(the global model: params and, for a BatchNorm model, ``batch_stats``), a
``meta.json`` with ``version`` / ``round_number`` /
``host_state`` (the seed, the convergence detector, the (ε, δ) ledger, the
RDP accountant of dp_sgd / client_dp / distributed, the PLD steps taken,
the adaptive clip norm), and one ``.pt`` file a piece of carried state:
``server_opt_state``, ``uplink_error``, ``scaffold`` (c, c_i), ``feddyn``
(h, g) and ``dp_ftrl`` (the true prefix sum, the last released noisy
prefix, the momentum, the per-client participation ledger and the tree
nonce as two u32 words, the reference's keys). Arrays load onto the
engine's device. A restored engine continues bit for bit as the
uninterrupted one: every per-round random stream is a pure function of
(seed, round, client), and the participation sampler's numpy state is in
``host_state`` too (the reference leaves it out, so its continuation
draws other masks unless they are given).

The clustered (IFCA), Ditto and async (FedBuff) engines' checkpoints are
the reference's pairs: the k stacked cluster models with the round and the
last assignments (k checked against ``meta.json`` before any array
loads); the personal models with ``steps_taken``, which keys the streams
(the kind checked first); the newest model and the version ring as
arrays, with the host event state (version, clock, cancellations,
attempts, the queue and the host generator's ``bit_generator.state``) in
``host_state`` (the kind checked first).

Under a client mesh every save and restore takes one path: the
per-client rows (the round engine's uplink error feedback, SCAFFOLD's
c_i, FedDyn's g_i; Ditto's personal models) are gathered from every rank,
rank 0 writes, and all ranks meet at a barrier; on restore each rank
reads the files and keeps its own rows. A checkpoint holds every client's
rows whatever the world size it was saved at, as the reference's global
arrays do, so it restores at any world size.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from fl_tpu_torch.core.pytree import (
    assert_same_structure, flatten_dict, tree_map)

logger = logging.getLogger(__name__)

CHECKPOINT_VERSION = 1


class CheckpointManager:
    """Round checkpoints as ``torch.save`` files with a JSON sidecar for
    host state; at most ``max_to_keep`` of them, the oldest removed."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"round_{step:08d}"

    def save(self, step: int, variables: Any,
             host_state: Optional[Dict[str, Any]] = None) -> Path:
        path = self._step_dir(step)
        path.mkdir(parents=True, exist_ok=True)
        torch.save(variables, path / "variables.pt")
        meta = {
            "version": CHECKPOINT_VERSION,
            "round_number": step,
            "host_state": host_state or {},
        }
        (path / "meta.json").write_text(json.dumps(meta, default=float))
        self._gc()
        logger.info("checkpoint saved at %s", path)
        return path

    def save_arrays(self, step: int, name: str, tree: Any) -> None:
        """One more piece of device state beside step ``step``'s model."""
        torch.save(tree, self._step_dir(step) / f"{name}.pt")

    def load_arrays(self, step: int, name: str, device) -> Optional[Any]:
        """Piece ``name`` of step ``step`` on ``device``, or None."""
        path = self._step_dir(step) / f"{name}.pt"
        if not path.exists():
            return None
        return torch.load(path, map_location=device, weights_only=True)

    def restore(self, step: Optional[int] = None,
                device="cpu") -> Dict[str, Any]:
        """The given (or latest) step: its round number, its variables on
        ``device`` and its host state."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._step_dir(step)
        meta = json.loads((path / "meta.json").read_text())
        return {
            "round_number": meta["round_number"],
            "variables": self.load_arrays(step, "variables", device),
            "host_state": meta.get("host_state", {}),
        }

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        return sorted(
            int(p.name.split("_")[1])
            for p in self.directory.glob("round_*") if p.is_dir()
        )

    def _gc(self) -> None:
        steps = self.all_steps()
        for step in steps[: max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)


# ---------------------------------------------------------------------------
# one path under a client mesh
# ---------------------------------------------------------------------------

def _writes(mesh) -> bool:
    """Rank 0 writes a checkpoint (every process without a mesh)."""
    return mesh is None or mesh.rank == 0


def _barrier(mesh) -> None:
    """Every rank waits until rank 0's files are on disk."""
    if mesh is not None and mesh.world_size > 1:
        dist.barrier(group=mesh.group)


def _own_rows(tree, rows):
    """This rank's rows [lo, hi) of every (C, ...) leaf of a restored
    tree."""
    lo, hi = rows
    return tree_map(lambda t: t[lo:hi].contiguous(), tree)


def _read_host_state(mgr: CheckpointManager, step: Optional[int]):
    """(step, meta.json's host_state) of the given or latest step, read
    before any array loads."""
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {mgr.directory}")
    meta = json.loads((mgr._step_dir(step) / "meta.json").read_text())
    return step, meta.get("host_state", {})


# ---------------------------------------------------------------------------
# engine integration
# ---------------------------------------------------------------------------

def engine_host_state(engine) -> Dict[str, Any]:
    """The host-side state of a FederatedRoundEngine, in the keys of the
    reference's ``host_state`` (plus the participation sampler's)."""
    det = engine.detector
    host_state: Dict[str, Any] = {
        "seed": engine.config.seed,
        "detector": {
            "best_accuracy": det.best_accuracy,
            "best_loss": (det.best_loss if np.isfinite(det.best_loss)
                          else None),
            "rounds_without_improvement": det.rounds_without_improvement,
        },
        "participation_rng": engine._np_rng.bit_generator.state,
    }
    if engine.budget_tracker is not None:
        host_state["privacy_budget"] = engine.budget_tracker.state_dict()
    if engine.rdp_accountant is not None:
        # without it a resumed client_dp run would restart RDP accounting
        # from zero and overdraw the ε bound
        host_state["rdp_accountant"] = engine.rdp_accountant.state_dict()
    if engine._pld_steps_taken:
        # the PLD gate counts certified steps; a resume without the count
        # would reopen the budget
        host_state["pld_steps_taken"] = int(engine._pld_steps_taken)
    if engine.clip_norm is not None:
        # adaptive clipping's C is round state
        host_state["clip_norm"] = float(engine.clip_norm)
    return host_state


def save_engine_checkpoint(engine, directory: str,
                           max_to_keep: int = 3) -> Path:
    """Snapshot a FederatedRoundEngine: the model, the round, the host
    state and every piece of carried device state its configuration has
    (under a mesh the per-client rows of every rank, written by rank
    0)."""
    mgr = CheckpointManager(directory, max_to_keep=max_to_keep)
    step = engine.round_number
    cfg = engine.config
    pieces = {}
    if engine.server_opt_state is not None:
        # FedAvgM / FedAdam / FedYogi moments: without them the server
        # optimizer would restart cold
        pieces["server_opt_state"] = engine.server_opt_state
    if cfg.uplink_compression != "none":
        # the per-client compression residual: dropping it would lose
        # pending updates
        pieces["uplink_error"] = {
            "ef": engine._axis.gather(engine.uplink_error)}
    if cfg.scaffold:
        pieces["scaffold"] = {
            "c": engine.scaffold_c,
            "ci": engine._axis.gather(engine.scaffold_ci)}
    if cfg.feddyn_alpha > 0:
        pieces["feddyn"] = {
            "h": engine.feddyn_h,
            "g": engine._axis.gather(engine.feddyn_grads)}
    if cfg.dp_mode == "dp_ftrl":
        # the mechanism state, and the ledger that enforces k: losing
        # either breaks the guarantee or the trajectory; the nonce keys
        # the regenerated node noise, so a resume must keep this tree's
        nonce = engine._ftrl_nonce
        pieces["dp_ftrl"] = {
            "cumsum": engine.ftrl_cumsum,
            "prev_noisy": engine.ftrl_prev_noisy,
            "momentum": engine.ftrl_momentum_buf,
            "participations": torch.from_numpy(
                engine.ftrl_participations.copy()),
            "tree_nonce": torch.tensor([nonce & 0xFFFFFFFF, nonce >> 32],
                                       dtype=torch.int64)}
    path = mgr._step_dir(step)
    if _writes(engine.mesh):
        path = mgr.save(step, engine.global_variables,
                        engine_host_state(engine))
        for name, tree in pieces.items():
            mgr.save_arrays(step, name, tree)
    _barrier(engine.mesh)
    return path


def load_host_state(engine, host_state: Dict[str, Any]) -> None:
    """Apply a checkpoint's ``host_state`` (the port's, or the reference's
    ``meta.json`` as it stands) to ``engine``."""
    hs = host_state
    if "privacy_budget" in hs and engine.budget_tracker is not None:
        engine.budget_tracker.load_state_dict(hs["privacy_budget"])
    if "rdp_accountant" in hs and engine.rdp_accountant is not None:
        engine.rdp_accountant.load_state_dict(hs["rdp_accountant"])
    if "pld_steps_taken" in hs:
        engine._pld_steps_taken = int(hs["pld_steps_taken"])
    if "clip_norm" in hs and engine.config.adaptive_clipping:
        engine.clip_norm = float(hs["clip_norm"])
    if "participation_rng" in hs:
        engine._np_rng.bit_generator.state = hs["participation_rng"]
    det = hs.get("detector", {})
    engine.detector.best_accuracy = det.get("best_accuracy", 0.0)
    bl = det.get("best_loss")
    engine.detector.best_loss = float("inf") if bl is None else bl
    engine.detector.rounds_without_improvement = det.get(
        "rounds_without_improvement", 0)


def restore_engine_checkpoint(engine, directory: str,
                              step: Optional[int] = None) -> int:
    """Restore a FederatedRoundEngine in place from the given (or latest)
    checkpoint; returns the round it resumes at. The checkpoint's model
    must have the engine's structure. Under a mesh every rank reads the
    files and keeps its own clients' rows."""
    mgr = CheckpointManager(directory)
    state = mgr.restore(step, device=engine.device)
    assert_same_structure(flatten_dict(engine.global_variables),
                          flatten_dict(state["variables"]))
    step = state["round_number"]
    engine.global_variables = state["variables"]
    engine.round_number = step
    cfg = engine.config
    dev = engine.device
    opt = mgr.load_arrays(step, "server_opt_state", dev)
    if opt is not None and engine._server_opt is not None:
        engine.server_opt_state = opt
    rows = engine._rows
    ef = mgr.load_arrays(step, "uplink_error", dev)
    if ef is not None and cfg.uplink_compression != "none":
        engine.uplink_error = _own_rows(ef["ef"], rows)
    sc = mgr.load_arrays(step, "scaffold", dev)
    if sc is not None and cfg.scaffold:
        engine.scaffold_c = sc["c"]
        engine.scaffold_ci = _own_rows(sc["ci"], rows)
    fd = mgr.load_arrays(step, "feddyn", dev)
    if fd is not None and cfg.feddyn_alpha > 0:
        engine.feddyn_h = fd["h"]
        engine.feddyn_grads = _own_rows(fd["g"], rows)
    st = mgr.load_arrays(step, "dp_ftrl", dev)
    if st is not None and cfg.dp_mode == "dp_ftrl":
        engine.ftrl_cumsum = st["cumsum"]
        engine.ftrl_prev_noisy = st["prev_noisy"]
        engine.ftrl_momentum_buf = st["momentum"]
        engine.ftrl_participations = st["participations"].cpu().numpy()
        lo, hi = (int(w) for w in st["tree_nonce"])
        engine._set_ftrl_nonce(lo | (hi << 32))
    load_host_state(engine, state["host_state"])
    logger.info("engine restored at round %d from %s", engine.round_number,
                directory)
    return engine.round_number


# ---------------------------------------------------------------------------
# clustered (IFCA) engine
# ---------------------------------------------------------------------------

def save_clustered_checkpoint(engine, directory: str) -> Path:
    """Snapshot a ClusteredFederatedEngine: the k stacked cluster models,
    the round and the last assignments. Each round's streams derive from
    (seed, round), so this is enough for an exact resume."""
    mgr = CheckpointManager(directory)
    path = mgr._step_dir(engine.round_number)
    if _writes(engine.mesh):
        host_state: Dict[str, Any] = {
            "kind": "clustered",
            "seed": engine.config.seed,
            "num_clusters": engine.config.num_clusters,
            "assignments": (None if engine.assignments is None
                            else [int(a) for a in engine.assignments]),
        }
        path = mgr.save(engine.round_number, engine.cluster_variables,
                        host_state)
    _barrier(engine.mesh)
    return path


def restore_clustered_checkpoint(engine, directory: str,
                                 step: Optional[int] = None) -> int:
    mgr = CheckpointManager(directory)
    # the metadata first: a k mismatch would otherwise surface as a shape
    # error after the arrays load
    step, hs = _read_host_state(mgr, step)
    if hs.get("num_clusters") != engine.config.num_clusters:
        raise ValueError(
            f"checkpoint holds {hs.get('num_clusters')} clusters; engine "
            f"configured for {engine.config.num_clusters}")
    state = mgr.restore(step, device=engine.device)
    assert_same_structure(flatten_dict(engine.cluster_variables),
                          flatten_dict(state["variables"]))
    engine.cluster_variables = state["variables"]
    engine.round_number = state["round_number"]
    a = hs.get("assignments")
    engine.assignments = None if a is None else np.asarray(a, np.int64)
    logger.info("clustered engine restored at round %d from %s",
                engine.round_number, directory)
    return engine.round_number


# ---------------------------------------------------------------------------
# Ditto personalizer
# ---------------------------------------------------------------------------

def save_ditto_checkpoint(personalizer, directory: str) -> Path:
    """Snapshot a DittoPersonalizer: every client's personal model and
    ``steps_taken``, which keys the passes' streams (a resume without it
    would replay spent randomness). The companion engine checkpoints
    separately through :func:`save_engine_checkpoint`."""
    eng = personalizer.engine
    personal = eng._axis.gather(personalizer.personal_variables)
    mgr = CheckpointManager(directory)
    path = mgr._step_dir(personalizer.steps_taken)
    if _writes(eng.mesh):
        path = mgr.save(personalizer.steps_taken, personal,
                        {"kind": "ditto", "lam": personalizer.lam,
                         "steps_taken": personalizer.steps_taken})
    _barrier(eng.mesh)
    return path


def restore_ditto_checkpoint(personalizer, directory: str,
                             step: Optional[int] = None) -> int:
    mgr = CheckpointManager(directory)
    step, hs = _read_host_state(mgr, step)
    if hs.get("kind") != "ditto":
        raise ValueError(f"{directory} does not hold a ditto checkpoint")
    eng = personalizer.engine
    state = mgr.restore(step, device=eng.device)
    assert_same_structure(flatten_dict(personalizer.personal_variables),
                          flatten_dict(state["variables"]))
    personalizer.personal_variables = _own_rows(state["variables"],
                                                eng._rows)
    personalizer.steps_taken = int(hs["steps_taken"])
    logger.info("ditto personalizer restored at step %d from %s",
                personalizer.steps_taken, directory)
    return personalizer.steps_taken


# ---------------------------------------------------------------------------
# asynchronous (FedBuff) engine
# ---------------------------------------------------------------------------

def save_async_checkpoint(engine, directory: str) -> Path:
    """Snapshot an AsyncFederatedEngine: the newest model and the version
    ring, and the HOST event state: the completion queue, the per-client
    attempt counters, the simulated clock and the host generator's state
    (the service-time draws must continue its stream, or the restored
    timeline diverges)."""
    mgr = CheckpointManager(directory)
    step = engine.server_step_count
    path = mgr._step_dir(step)
    if _writes(engine.mesh):
        host_state: Dict[str, Any] = {
            "kind": "async",
            "seed": engine.config.seed,
            "version": engine.version,
            "sim_time": engine.sim_time,
            "cancelled_attempts": engine.cancelled_attempts,
            "attempts": [int(a) for a in engine._attempts],
            "queue": [[float(t), int(c), int(v), int(a)]
                      for (t, c, v, a) in sorted(engine._queue)],
            "rng_state": engine._host_rng.bit_generator.state,
        }
        path = mgr.save(step, engine.global_variables, host_state)
        mgr.save_arrays(step, "ring", engine.ring)
    _barrier(engine.mesh)
    return path


def restore_async_checkpoint(engine, directory: str,
                             step: Optional[int] = None) -> int:
    import heapq

    mgr = CheckpointManager(directory)
    # the kind first: a foreign checkpoint would otherwise surface as a
    # structure error after the arrays load
    step, hs = _read_host_state(mgr, step)
    if hs.get("kind") != "async":
        raise ValueError(f"{directory} does not hold an async checkpoint")
    state = mgr.restore(step, device=engine.device)
    ring = mgr.load_arrays(step, "ring", engine.device)
    assert_same_structure(flatten_dict(engine.global_variables),
                          flatten_dict(state["variables"]))
    assert_same_structure(flatten_dict(engine.ring), flatten_dict(ring))
    engine.global_variables = state["variables"]
    engine.server_step_count = state["round_number"]
    engine.ring = ring
    engine.version = int(hs["version"])
    engine.sim_time = float(hs["sim_time"])
    engine.cancelled_attempts = int(hs["cancelled_attempts"])
    engine._attempts = np.asarray(hs["attempts"], np.int64)
    engine._queue = [(float(t), int(c), int(v), int(a))
                     for t, c, v, a in hs["queue"]]
    heapq.heapify(engine._queue)
    engine._host_rng.bit_generator.state = hs["rng_state"]
    logger.info("async engine restored at server step %d from %s",
                engine.server_step_count, directory)
    return engine.server_step_count
