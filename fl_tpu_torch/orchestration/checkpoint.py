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

Not ported yet: the clustered, Ditto and async engines' checkpoints (with
those engines).
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from fl_tpu_torch.core.pytree import assert_same_structure, flatten_dict

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
    state and every piece of carried device state its configuration has."""
    mgr = CheckpointManager(directory, max_to_keep=max_to_keep)
    step = engine.round_number
    path = mgr.save(step, engine.global_variables, engine_host_state(engine))
    cfg = engine.config
    if engine.server_opt_state is not None:
        # FedAvgM / FedAdam / FedYogi moments: without them the server
        # optimizer would restart cold
        mgr.save_arrays(step, "server_opt_state", engine.server_opt_state)
    if cfg.uplink_compression != "none":
        # the per-client compression residual: dropping it would lose
        # pending updates
        mgr.save_arrays(step, "uplink_error", {"ef": engine.uplink_error})
    if cfg.scaffold:
        mgr.save_arrays(step, "scaffold", {"c": engine.scaffold_c,
                                           "ci": engine.scaffold_ci})
    if cfg.feddyn_alpha > 0:
        mgr.save_arrays(step, "feddyn", {"h": engine.feddyn_h,
                                         "g": engine.feddyn_grads})
    if cfg.dp_mode == "dp_ftrl":
        # the mechanism state, and the ledger that enforces k: losing
        # either breaks the guarantee or the trajectory; the nonce keys
        # the regenerated node noise, so a resume must keep this tree's
        nonce = engine._ftrl_nonce
        mgr.save_arrays(step, "dp_ftrl", {
            "cumsum": engine.ftrl_cumsum,
            "prev_noisy": engine.ftrl_prev_noisy,
            "momentum": engine.ftrl_momentum_buf,
            "participations": torch.from_numpy(
                engine.ftrl_participations.copy()),
            "tree_nonce": torch.tensor([nonce & 0xFFFFFFFF, nonce >> 32],
                                       dtype=torch.int64)})
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
    must have the engine's structure."""
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
    ef = mgr.load_arrays(step, "uplink_error", dev)
    if ef is not None and cfg.uplink_compression != "none":
        engine.uplink_error = ef["ef"]
    sc = mgr.load_arrays(step, "scaffold", dev)
    if sc is not None and cfg.scaffold:
        engine.scaffold_c, engine.scaffold_ci = sc["c"], sc["ci"]
    fd = mgr.load_arrays(step, "feddyn", dev)
    if fd is not None and cfg.feddyn_alpha > 0:
        engine.feddyn_h, engine.feddyn_grads = fd["h"], fd["g"]
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
