"""Utility-based client selection (Oort-style, Lai et al. OSDI 2021); a
copy of ``fl_tpu.orchestration.selection`` (numpy only), which gives the
same masks and state bit for bit for the same seed and the same losses.

Selection is control plane: it runs on the host between rounds, and the
engine's superstep stays on the device. Round r+1's mask needs round r's
``engine.last_client_losses``, which the engine fills when it finalizes a
round, so selected rounds run one after another through ``run_round``
(``run_rounds_pipelined(masks=)`` takes masks fixed in advance).

- **statistical utility**: ``U_i = n_i · loss_i`` from the engine's
  per-client training losses (``engine.last_client_losses``), the
  monotone proxy of Oort's n·√(mean per-sample loss²).
- **temporal uncertainty bonus** (§5.1): ``+ U̅ · √(0.1·ln r / r_i)``
  where r_i is the round the client was last picked.
- **system utility**: optional per-client durations; clients slower than
  the round's desired duration T are scaled by ``(T / t_i)^α``.
- **ε-greedy exploration** with decay: a fraction of each round's slots
  goes to never-explored clients (uniformly), the rest to the top-utility
  explored ones; ε decays ×``explore_decay`` per round to a floor.

Utility-biased selection is data-dependent, which voids Poisson-subsampling
amplification: pair it with dp_mode="none", or with DP-FTRL (whose
guarantee holds for arbitrary participation orderings; cap participations
yourself), or with per-release ("delta") DP. The selector refuses nothing;
the engine's own accounting stays authoritative.

Usage::

    sel = OortSelector(engine.num_clients, seed=0)
    num_samples = np.asarray(arrays.num_samples)   # the host shard sizes
    for _ in range(rounds):
        mask = sel.select_mask(k=64)
        engine.run_round(mask=mask)
        sel.update(mask, engine.last_client_losses, num_samples=num_samples)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class OortSelector:
    """Host-side Oort selection state."""

    num_clients: int
    fraction_explore: float = 0.3
    explore_decay: float = 0.98
    min_explore: float = 0.1
    straggler_alpha: float = 2.0          # (T/t_i)^α penalty exponent
    desired_duration: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.fraction_explore <= 1.0:
            raise ValueError("fraction_explore must be in [0, 1]")
        if self.num_clients < 1:
            raise ValueError("num_clients must be >= 1")
        self._rng = np.random.default_rng(self.seed)
        self._utility = np.zeros(self.num_clients, np.float64)
        self._explored = np.zeros(self.num_clients, bool)
        # absolute round at which each client was last selected (Oort's
        # R_i); small R_i relative to the current round R grows the
        # √(0.1·ln R / R_i) bonus, recirculating stale utilities
        self._last_selected = np.ones(self.num_clients, np.int64)
        self._round = 0
        self._explore = float(self.fraction_explore)

    # ------------------------------------------------------------------
    def select_mask(self, k: int) -> np.ndarray:
        """Pick ``k`` clients for the next round; returns a (C,) f32 mask
        consumable by ``FederatedRoundEngine.run_round(mask=...)``."""
        if not 1 <= k <= self.num_clients:
            raise ValueError(
                f"k must be in [1, {self.num_clients}], got {k}")
        unexplored = np.flatnonzero(~self._explored)
        n_explore = min(len(unexplored),
                        int(round(self._explore * k)))
        # never-seen clients always fill otherwise-empty exploit slots
        explored_pool = np.flatnonzero(self._explored)
        n_exploit = min(k - n_explore, len(explored_pool))
        n_explore = k - n_exploit

        picks = []
        if n_explore > 0:
            picks.append(self._rng.choice(
                unexplored, size=n_explore, replace=False))
        if n_exploit > 0:
            # temporal uncertainty bonus keeps stale utilities circulating
            r = max(self._round, 1)
            bonus_scale = max(float(
                self._utility[self._explored].mean()), 1e-9)
            last = np.maximum(self._last_selected[explored_pool], 1)
            score = (self._utility[explored_pool]
                     + bonus_scale * np.sqrt(0.1 * math.log(r + 1) / last))
            # jitter breaks exact ties stochastically (fresh selectors)
            score = score + self._rng.uniform(0, 1e-12, score.shape)
            top = explored_pool[np.argsort(-score)[:n_exploit]]
            picks.append(top)
        chosen = np.concatenate(picks) if picks else np.asarray([], int)
        mask = np.zeros(self.num_clients, np.float32)
        mask[chosen.astype(int)] = 1.0
        return mask

    # ------------------------------------------------------------------
    def update(
        self,
        mask: np.ndarray,
        client_losses: np.ndarray,
        num_samples: Optional[np.ndarray] = None,
        durations: Optional[np.ndarray] = None,
    ) -> None:
        """Fold one round's outcomes into the utility state. Only entries
        where ``mask > 0`` are read (the engine's per-client metrics are
        meaningless for non-participants)."""
        mask = np.asarray(mask) > 0
        losses = np.nan_to_num(
            np.asarray(client_losses, np.float64), nan=0.0,
            posinf=0.0, neginf=0.0)
        util = np.maximum(losses, 0.0)
        if num_samples is not None:
            util = util * np.asarray(num_samples, np.float64)
        if durations is not None and self.desired_duration is not None:
            t = np.maximum(np.asarray(durations, np.float64), 1e-9)
            penalty = np.minimum(
                1.0, (self.desired_duration / t) ** self.straggler_alpha)
            util = util * penalty
        self._round += 1
        self._utility[mask] = util[mask]
        self._explored[mask] = True
        self._last_selected[mask] = self._round
        self._explore = max(self.min_explore,
                            self._explore * self.explore_decay)

    # ------------------------------------------------------------------
    def state(self) -> Dict[str, np.ndarray]:
        """Introspection/checkpoint view."""
        return {
            "utility": self._utility.copy(),
            "explored": self._explored.copy(),
            "last_selected_round": self._last_selected.copy(),
            "round": np.asarray(self._round),
            "explore_fraction": np.asarray(self._explore),
        }
