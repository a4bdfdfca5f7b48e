"""Distributed DP: the Skellam mechanism over modular integer aggregation.

The port of ``fl_tpu.fl.distributed_dp`` (Agarwal, Kairouz, Liu, "The
Skellam Mechanism for Differentially Private Federated Learning", NeurIPS
2021). Each client clips its delta to L2 norm c, scales it by 1/γ,
stochastically rounds it to the integer lattice (unbiased; the integer L2
sensitivity is then c/γ + √d), adds its share Sk(μ/n) = Pois(μ/2n) −
Pois(μ/2n) of integer noise, and only the sum mod 2^32 over the
participants is decoded: Skellam is closed under addition, so the sum
carries exactly Sk(μ) and the release is private before the server sees
it. Because everything is exact integer arithmetic, pairwise masks over
Z_2^32 (:func:`masked_integer_payloads`) cancel bit for bit.

The host side (the plan, the Skellam RDP bound, the exact Rényi
divergence, calibration, the wraparound certificate, the wire payload
functions) is a copy of the reference's numpy code and gives equal values.

The device side works on tensors. Two of its points differ from JAX's
int32 arithmetic and are handled here:

- ``torch.sum`` of int32 returns int64. The modular sum is that int64 sum
  reduced mod 2^32 and read as two's-complement int32
  (:func:`wrap_int32`, :func:`modular_sum`), which equals the int32 sum
  that wraps; :func:`check_no_wraparound` certifies at config time that
  the true sum lies inside ±2^31, so the decode is exact.
- the Poisson draws are ``torch.poisson`` on float64 rates: the bench's
  aggregate rate is above 2^24, where an f32 count could not hold every
  integer.

Random streams are seeds (``core.prng``). The per-client draws (the
rounding's uniforms, the per-client Skellam shares) take one generator a
client, seeded fold(seed, c) by GLOBAL client id c as the reference folds
one key a client, so a client draws the same whichever shard of the client
axis holds it; the aggregate noise is one draw from the round's seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.fl.accounting import DEFAULT_ALPHAS, eps_from_rdp

MOD = 2 ** 32


# ===========================================================================
# Host-side: plan, sensitivity, accounting
# ===========================================================================

@dataclass(frozen=True)
class DistributedDPPlan:
    """Static parameters of one distributed-DP deployment, derived once at
    engine-config time from (clip norm, grid bits, model dim, cohort)."""

    clip_norm: float      # c: float L2 clip
    bits: int             # grid resolution: gamma = c / 2^bits
    dim: int              # d: REAL (unpadded) flat parameter count
    expected_clients: int  # m̄: fixed denominator + noise-split target
    noise_multiplier: float  # z: central noise std = z·Δ₂ grid units

    @property
    def gamma(self) -> float:
        return self.clip_norm / float(2 ** self.bits)

    @property
    def delta2(self) -> float:
        """Integer L2 sensitivity: grid-scaled clip + the deterministic
        stochastic-rounding inflation. Each coordinate errs by < 1 in
        exact arithmetic; the f32 add x/γ + u can round the sum by one ulp
        at magnitude 2^bits, so the per-coordinate bound is
        1 + 2^(bits−23)."""
        per_coord = 1.0 + 2.0 ** (self.bits - 23)
        return float(2 ** self.bits) + per_coord * math.sqrt(self.dim)

    @property
    def delta1(self) -> float:
        """Integer L1 sensitivity bound (Cauchy–Schwarz from Δ₂)."""
        return math.sqrt(self.dim) * self.delta2

    @property
    def mu_central(self) -> float:
        """Target variance of the summed noise, grid units: (z·Δ₂)²."""
        return (self.noise_multiplier * self.delta2) ** 2

    @property
    def mu_local(self) -> float:
        """Per-client Skellam variance: each of m̄ expected participants
        contributes Sk(μ_central/m̄); closure makes the realized sum
        Sk(m·μ_central/m̄)."""
        return self.mu_central / max(1, self.expected_clients)

    def central_sigma_float(self, realized: int) -> float:
        """Std of the noise on the DECODED AVERAGE delta, float units,
        given the realized participant count."""
        mu = self.mu_local * max(0, realized)
        return self.gamma * math.sqrt(mu) / max(1, self.expected_clients)

    def round_rdp(self, realized: int,
                  alphas: Sequence[int] = DEFAULT_ALPHAS) -> np.ndarray:
        """Per-round RDP vector at the realized participant count."""
        if realized <= 0:
            # no participant data entered the release: the sum is the
            # deterministic zero vector — nothing to account
            return np.zeros(len(alphas))
        return skellam_rdp(self.mu_local * realized, self.delta2,
                           self.delta1, alphas)


def skellam_rdp(mu: float, delta2: float, delta1: float,
                alphas: Sequence[int] = DEFAULT_ALPHAS) -> np.ndarray:
    """RDP(α) upper bound of the multidimensional Skellam mechanism with
    per-coordinate noise variance ``mu``, integer L2 sensitivity ``delta2``
    and L1 sensitivity ``delta1`` (Agarwal et al. 2021, Thm. 3.3):

        ε(α) ≤ α·Δ₂²/(2μ) + min( ((2α−1)·Δ₂² + 6·Δ₁)/(4μ²),  3·Δ₁/(2μ²) )
    """
    if mu <= 0:
        return np.full(len(alphas), np.inf)
    a = np.asarray(alphas, np.float64)
    gauss = a * delta2 ** 2 / (2.0 * mu)
    corr = np.minimum(
        ((2.0 * a - 1.0) * delta2 ** 2 + 6.0 * delta1) / (4.0 * mu ** 2),
        3.0 * delta1 / (2.0 * mu ** 2),
    )
    return gauss + corr


def _skellam_log_pmf(k: np.ndarray, mu: float) -> np.ndarray:
    """Exact log pmf of Sk(μ) = Pois(μ/2) − Pois(μ/2) at integer points
    ``k``, in log space:

        log pmf(k) = −μ + logsumexp_j [(|k|+2j)·log(μ/2)
                                       − lgamma(|k|+j+1) − lgamma(j+1)]

    over a j-window of ±(12√(j*+1)+60) around the series' peak j*."""
    from scipy.special import gammaln, logsumexp

    k = np.abs(np.asarray(k, np.int64))
    half = mu / 2.0
    jstar = 0.5 * (-k + np.sqrt(k.astype(np.float64) ** 2 + mu ** 2))
    width = (12.0 * np.sqrt(jstar + 1.0) + 60.0).astype(np.int64)
    j0 = np.maximum(0, (jstar - width).astype(np.int64))
    wmax = int((2 * width).max()) + 1
    j = j0[:, None] + np.arange(wmax)[None, :]          # (K, W)
    terms = ((k[:, None] + 2 * j) * math.log(half)
             - gammaln(k[:, None] + j + 1.0) - gammaln(j + 1.0))
    return -mu + logsumexp(terms, axis=1)


def skellam_renyi_divergence_exact(mu: float, shift: int,
                                   alpha: float) -> float:
    """Numerically exact D_α( Sk(μ)+shift ‖ Sk(μ) ) for a 1-D integer
    shift, in log space through :func:`_skellam_log_pmf` (the accounting
    tests' oracle; not on the round's path)."""
    if shift == 0:
        return 0.0
    shift = abs(int(shift))
    w = int(40.0 * math.sqrt(mu) + 10 * shift + 50)
    center = int(alpha * shift)
    k = np.arange(min(0, center) - w, max(0, center) + w + 1)
    lq = _skellam_log_pmf(k, mu)
    lp = _skellam_log_pmf(k - shift, mu)
    t = alpha * lp + (1.0 - alpha) * lq
    m = np.max(t)
    log_sum = m + math.log(np.sum(np.exp(t - m)))
    return float(log_sum / (alpha - 1.0))


def distributed_epsilon(plan: DistributedDPPlan, rounds: int,
                        delta: float,
                        realized: int = None) -> float:
    """Total (ε, δ)-DP after ``rounds`` full-participation rounds (or at an
    explicit realized count) — the host-side calibration helper."""
    m = plan.expected_clients if realized is None else realized
    rdp = plan.round_rdp(m) * rounds
    return eps_from_rdp(rdp, delta)[0]


def calibrate_noise_multiplier(
    target_epsilon: float, delta: float, rounds: int,
    clip_norm: float, bits: int, dim: int, expected_clients: int,
    z_lo: float = 0.05, z_hi: float = 256.0, tol: float = 1e-3,
) -> float:
    """Smallest z whose total ε over ``rounds`` rounds fits the target."""
    def eps_at(z: float) -> float:
        plan = DistributedDPPlan(clip_norm, bits, dim, expected_clients, z)
        return distributed_epsilon(plan, rounds, delta)

    if eps_at(z_hi) > target_epsilon:
        raise ValueError(f"ε={target_epsilon} unreachable even at z={z_hi}")
    if eps_at(z_lo) <= target_epsilon:
        return z_lo
    lo, hi = z_lo, z_hi
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if eps_at(mid) > target_epsilon:
            lo = mid
        else:
            hi = mid
    return hi


def check_no_wraparound(plan: DistributedDPPlan, num_clients: int) -> None:
    """Certify the true integer sum stays inside ±2^31 so the signed decode
    is exact: worst-case data mass + a 12σ noise tail."""
    data = num_clients * (2 ** plan.bits + 1)
    noise = 12.0 * math.sqrt(plan.mu_local * num_clients)
    if data + noise >= 2 ** 31:
        raise ValueError(
            f"distributed-DP overflow risk: {num_clients} clients at "
            f"bits={plan.bits}, z={plan.noise_multiplier} put the sum's "
            f"12σ envelope at {data + noise:.3g} ≥ 2^31; lower dist_bits "
            "or the client count")


# ===========================================================================
# Device-side: the integer pipeline
# ===========================================================================

def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced mod 2^32 and read as two's-complement int32:
    what int32 arithmetic that wraps would have given."""
    return (torch.remainder(x + 2 ** 31, MOD) - 2 ** 31).to(torch.int32)


def modular_sum(ints: torch.Tensor) -> torch.Tensor:
    """(C, D) int32 payloads → (D,) int32 sum mod 2^32 (``torch.sum`` of
    int32 gives int64; it is wrapped back)."""
    return wrap_int32(ints.sum(0, dtype=torch.int64))


def _client_generators(seed: int, num_clients: int, first: int, device):
    """One generator a client, seeded fold(seed, c) for the global ids c =
    first, …, first + C − 1."""
    return [prng.generator(int(s), device)
            for s in prng.client_seeds_of(seed, num_clients, first)]


def stochastic_round(mat: torch.Tensor, gamma: float, seed: int,
                     first: int = 0) -> torch.Tensor:
    """(C, D) f32 → int32 lattice, unbiased: floor(x/γ + U[0, 1)) in f32,
    row r's U drawn from fold(``seed``, first + r), its global client id.
    Exact zeros (padding, untouched coordinates) round to exactly 0."""
    u = torch.empty(mat.shape, dtype=torch.float32, device=mat.device)
    for r, g in enumerate(_client_generators(seed, mat.shape[0], first,
                                             mat.device)):
        torch.rand(mat.shape[1:], generator=g, out=u[r])
    return torch.floor(mat / torch.tensor(gamma, dtype=torch.float32)
                       + u).to(torch.int32)


def _poisson(lam: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return torch.poisson(lam, generator=generator).to(torch.int64)


def skellam_noise(seed: int, lam: float, shape, device="cpu"
                  ) -> torch.Tensor:
    """int32 Skellam Sk(2·lam) draws of ``shape``: Pois(lam) − Pois(lam),
    the two counts from one generator on float64 rates."""
    g = prng.generator(seed, device)
    rates = torch.full(tuple(shape), float(lam), dtype=torch.float64,
                       device=device)
    return (_poisson(rates, g) - _poisson(rates, g)).to(torch.int32)


def aggregate_skellam_noise(seed: int, lam_total, dim: int,
                            device=None) -> torch.Tensor:
    """(dim,) int64 Sk(2·lam_total) draw: the exact distribution of the
    summed per-client shares (Skellam closure: Σ_m Sk(μ/m̄) = Sk(m·μ/m̄)),
    sampled once on the aggregate. ``lam_total`` may be a 0-d tensor (it
    scales with the realized participant count). int64: at the bench's
    rates the two counts pass 2^24, and the caller wraps the sum."""
    lam = torch.as_tensor(lam_total, dtype=torch.float64, device=device)
    g = prng.generator(seed, lam.device)
    rates = lam.reshape(1).expand(dim).contiguous()
    return _poisson(rates, g) - _poisson(rates, g)


def client_integer_payloads(mat: torch.Tensor, mask: torch.Tensor,
                            round_seed: int, noise_seed: int, gamma: float,
                            mu_local: float, first: int = 0) -> torch.Tensor:
    """Each participant's int32 wire payload: round(clipped/γ) + its
    Sk(μ_local) share, mod 2^32; non-participants send exact zeros. Row r
    is global client first + r: its rounding draws from fold(round_seed,
    first + r), its share from fold(noise_seed, first + r)."""
    ints = stochastic_round(mat, gamma, round_seed, first).to(torch.int64)
    for r, s in enumerate(prng.client_seeds_of(noise_seed, mat.shape[0],
                                               first)):
        ints[r] += skellam_noise(int(s), mu_local / 2.0, mat.shape[1:],
                                 mat.device).to(torch.int64)
    return wrap_int32(ints) * (mask > 0).to(torch.int32)[:, None]


def decode_average(total_int: torch.Tensor, gamma: float,
                   expected_clients: int) -> torch.Tensor:
    """Modular int32 sum → float average delta against the FIXED expected
    denominator (client_dp's sensitivity convention), in f32."""
    return (total_int.to(torch.float32)
            * torch.tensor(gamma, dtype=torch.float32)
            / float(max(1, expected_clients)))


def pairwise_integer_masks(seed: int, num_clients: int, dim: int,
                           neighbors: int = 8, alive=None,
                           device="cpu") -> torch.Tensor:
    """(C, D) int32 pairwise masks over a ring graph that cancel BIT-EXACTLY
    mod 2^32: offset o's words are one uniform (C, D) draw from fold(seed,
    o), row i the pair (i, i + o), added at i and subtracted at i + o, zero
    where either end is not alive. Uniform over Z_2^32, so each masked
    payload is marginally uniform."""
    C, D = num_clients, dim
    k = min(neighbors, max(C - 1, 0))
    live = (torch.ones((C,), device=device) if alive is None
            else torch.as_tensor(alive, device=device)) > 0
    masks = torch.zeros((C, D), dtype=torch.int64, device=device)
    for o in range(1, k + 1):
        g = prng.generator(prng.fold(seed, o), device)
        words = torch.randint(0, MOD, (C, D), generator=g, device=device,
                              dtype=torch.int64)
        both = (live & torch.roll(live, -o)).to(torch.int64)
        words = words * both[:, None]
        masks += words - torch.roll(words, o, 0)
    return wrap_int32(masks)


# ===========================================================================
# Host-side pipeline for wire clients (numpy)
# ===========================================================================

def host_client_integer_payload(
        weights: dict, plan: DistributedDPPlan,
        rng: np.random.Generator) -> dict:
    """One wire client's distributed-DP payload: clip the CONCATENATED
    delta to the plan's L2 norm, γ-grid stochastic-round, add this
    client's Skellam share — returned as per-layer uint32 arrays (sorted-key
    layout, the wire protocol's)."""
    keys = sorted(weights.keys())
    flats = [np.asarray(weights[k], np.float64).ravel() for k in keys]
    flat = np.concatenate(flats)
    norm = float(np.linalg.norm(flat))
    if norm > plan.clip_norm:
        flat = flat * (plan.clip_norm / norm)
    scaled = flat / plan.gamma
    ints = np.floor(scaled + rng.random(flat.size)).astype(np.int64)
    lam = plan.mu_local / 2.0
    ints += rng.poisson(lam, flat.size) - rng.poisson(lam, flat.size)
    u32 = (ints % MOD).astype(np.uint32)
    out, offset = {}, 0
    for k in keys:
        w = np.asarray(weights[k])
        out[k] = u32[offset: offset + w.size].reshape(w.shape)
        offset += w.size
    return out


def host_decode_average(summed_u32: dict, plan: DistributedDPPlan) -> dict:
    """Decode the unmasked mod-2^32 per-layer sums (server side): centered
    signed interpretation × γ / m̄ — the average delta under the FIXED
    expected denominator, float32 per layer."""
    out = {}
    for k, v in summed_u32.items():
        s = np.asarray(v, np.uint32).astype(np.int64)
        s = np.where(s >= 2 ** 31, s - MOD, s)
        out[k] = (s.astype(np.float64) * plan.gamma
                  / max(1, plan.expected_clients)).astype(np.float32)
    return out


def masked_integer_payloads(mat: torch.Tensor, mask: torch.Tensor,
                            round_seed: int, noise_seed: int,
                            mask_seed: int, gamma: float, mu_local: float,
                            neighbors: int = 8) -> torch.Tensor:
    """What an on-device secure aggregator would SEE a client: the integer
    payload plus exactly-cancelling pairwise masks — marginally uniform on
    Z_2^32, summing (mod 2^32) to the same total as the unmasked payloads.
    Inspection and test surface; the engine sums the payloads directly,
    the masks being an algebraic no-op on the sum."""
    ints = client_integer_payloads(mat, mask, round_seed, noise_seed, gamma,
                                   mu_local)
    masks = pairwise_integer_masks(mask_seed, mat.shape[0], mat.shape[1],
                                   neighbors, alive=mask, device=mat.device)
    return wrap_int32(ints.to(torch.int64) + masks.to(torch.int64))
