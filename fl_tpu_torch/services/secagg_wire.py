"""Deployment-grade secure aggregation over the gRPC wire (port of
``fl_tpu.services.secagg_wire``).

Implements the full **Bonawitz et al., CCS'17** protocol ("Practical Secure
Aggregation for Privacy-Preserving Machine Learning"): double masking over
the integers mod 2^32 with Shamir t-of-n dropout recovery. This replaces
the v1 float Gaussian pairwise masking (whose hiding depended on a scale
parameter dominating ``n·|θ|`` and whose cancellation carried float
rounding residue) with PERFECTLY hiding, EXACTLY cancelling uniform masks.

Protocol phases (client ↔ coordinator; clients never talk to each other —
the coordinator ferries ciphertexts it cannot read):

0. **Roster.** Clients advertise X25519 public keys at registration
   (``ClientRegistration.metadata["secagg_pubkey"]``, hex). The coordinator
   freezes a roster of (client_id, pubkey) pairs once ``min_clients`` keys
   are live, stamped with a fresh random ``roster_nonce`` — every mask seed
   folds the nonce in, so a retry re-freeze under the same round number can
   never reuse masks (an adversarial coordinator partitioning clients
   across retry rosters would otherwise solve for individual payloads).
1. **Share distribution.** Client *i* Shamir-splits (t-of-n) BOTH its DH
   private key ``sk_i`` and a fresh self-mask seed ``b_i``, encrypts the
   (x, y_sk, y_b) bundle for each peer *j* under an AES-GCM key derived
   from ``DH(sk_i, pk_j)``, and uploads the ciphertexts; each client then
   downloads the bundles addressed to it.
2. **Masked upload.** Client *i* submits, per coordinate,
   ``enc(n_i·θ_i) + PRG(b_i) + Σ_j ±PRG(s_ij)  (mod 2^32)``
   where ``s_ij`` is the pair seed from ``DH(sk_i, pk_j)``, signs by id
   order, and ``enc`` is fixed-point with a wraparound refusal bound.
   Sample-count prescaling keeps the weighted mean recoverable.
3. **Reveal.** Once the coordinator freezes the survivor set (everyone
   whose masked payload arrived), each survivor reveals its shares of
   ``b_j`` for SURVIVORS and of ``sk_j`` for DROPPED peers — never both
   for the same subject (a client also refuses to reveal at all unless it
   is itself a listed survivor and the survivor set meets the threshold).
4. **Unmask.** With ≥ t reveals the coordinator reconstructs each
   survivor's ``b_j`` (removing self masks) and each dropped client's
   ``sk_j`` (recomputing and removing the survivors' unpaired masks), then
   decodes ``Σ n_i·θ_i / Σ n_i``. Individual payloads stay uniform.

Security: honest-but-curious coordinator, up to t-1 colluding clients.
Active-adversary client_id hijacking requires mTLS identity binding
(CoordinatorGRPCServer ``tls_client_ca_path``); see RegisterClient's
pubkey-continuity guard for the partial in-band defense. DP composes by
noising BEFORE masking on the client (masking is post-processing).

The protocol runs on the host in numpy, as in the reference; the client
FSM hands it the payload after its device-side DP release (K3 on a card).
Sessions and server rounds of this module and of the reference's
interoperate in one roster: every seed, nonce, layout and message is the
same.
"""

from __future__ import annotations

import hashlib
import logging
import math
import random
import secrets
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fl_tpu_torch.core.types import GlobalModel, ModelUpdate
from fl_tpu_torch.services import secagg_crypto as sc
from fl_tpu_torch.services.secagg_crypto import generate_keypair  # noqa: F401

logger = logging.getLogger(__name__)

PUBKEY_METADATA_KEY = "secagg_pubkey"


def default_threshold(n: int) -> int:
    """Bonawitz §7 recommends t > 2n/3 for robustness against mixed
    dropout+collusion; ceil(2n/3) bounded below by 2."""
    return max(2, -(-2 * n // 3))


def pair_graph_degree(n: int) -> int:
    """Pairwise-mask graph degree: complete for small rosters, k-regular
    with k = Θ(log n) beyond (SecAgg+, Bell et al. CCS'20 — a sparse
    random-ish graph keeps the sum hidden w.h.p. while cutting each
    client's mask-PRG work and the dropout-recovery cost from O(n) to
    O(log n) length-D streams). Even, ≥ 8, capped at n−1."""
    if n <= 16:
        return max(0, n - 1)
    k = max(8, 2 * math.ceil(math.log2(n)))
    if k % 2:
        k += 1
    return min(n - 1, k)


def pair_neighbors(ids: Sequence[str], nonce: bytes) -> Dict[str, set]:
    """Deterministic k-regular pairing graph over the roster: a circulant
    (ring ± degree/2 offsets) laid over a roster-nonce-keyed random
    permutation of the ids — every party derives the IDENTICAL graph from
    (roster, nonce), no extra wire fields. The nonce-keyed permutation
    randomizes the graph per roster freeze (a fixed circulant would let an
    adversary pre-position colluders around a victim)."""
    ids = list(ids)
    n = len(ids)
    k = pair_graph_degree(n)
    if k >= n - 1:
        return {cid: set(ids) - {cid} for cid in ids}
    seed = int.from_bytes(
        hashlib.sha256(b"secagg-graph|" + bytes(nonce)
                       + b"|" + "|".join(ids).encode()).digest()[:8],
        "big")
    perm = list(ids)
    random.Random(seed).shuffle(perm)
    nb: Dict[str, set] = {cid: set() for cid in ids}
    for i, cid in enumerate(perm):
        for o in range(1, k // 2 + 1):
            for j in ((i + o) % n, (i - o) % n):
                nb[cid].add(perm[j])
                nb[perm[j]].add(cid)
    return nb


def _flat_order(weights) -> List[str]:
    return sorted(weights.keys())


def _aad(kind: bytes, a: str, b: str, round_number: int,
         nonce: bytes) -> bytes:
    return b"|".join([kind, a.encode(), b.encode(),
                      str(round_number).encode(), nonce.hex().encode()])


# ===========================================================================
# Client side
# ===========================================================================

class SecAggClientSession:
    """One client's view of one roster freeze. One-shot by design: a fresh
    session (with the new roster_nonce) is created per freeze, so masks are
    never reused across retries and the same payload is never masked twice
    under one roster."""

    def __init__(self, client_id: str, sk, round_number: int,
                 roster: Sequence[Tuple[str, bytes]], roster_nonce: bytes,
                 threshold: int, frac_bits: int = sc.DEFAULT_FRAC_BITS):
        ids = [cid for cid, _ in roster]
        if client_id not in ids:
            raise ValueError(f"{client_id} is not in the roster")
        if sorted(ids) != ids:
            raise ValueError("roster must be sorted by client_id")
        if len(set(ids)) != len(ids):
            raise ValueError("roster contains duplicate client ids")
        if not 1 <= threshold <= len(ids):
            raise ValueError(f"threshold {threshold} invalid for roster "
                             f"of {len(ids)}")
        self.client_id = client_id
        self.sk = sk
        self.round_number = int(round_number)
        self.roster = [(cid, bytes(pub)) for cid, pub in roster]
        self.roster_nonce = bytes(roster_nonce)
        self.threshold = int(threshold)
        self.frac_bits = int(frac_bits)
        self._index = {cid: i + 1 for i, (cid, _) in enumerate(self.roster)}
        self._pub = dict(self.roster)
        # sparse pairwise-mask graph (SecAgg+): derived identically by
        # every party from (roster, nonce). Shamir shares still go to the
        # FULL roster (32-byte secrets — cheap); only the length-D mask
        # streams are restricted to neighbors. The FULL graph is kept:
        # reveal() audits the coordinator's survivor partition against it
        # (isolation guard below).
        self._graph = pair_neighbors(ids, self.roster_nonce)
        self._neighbors = self._graph[client_id]

        # fresh self-mask seed per session (= per roster freeze)
        self.b = secrets.token_bytes(32)
        n = len(self.roster)
        sk_shares = sc.shamir_split(sc.private_key_bytes(sk), n, threshold)
        b_shares = sc.shamir_split(self.b, n, threshold)
        # x-coordinate == 1-based roster index of the HOLDER
        self._outgoing = {
            cid: (sk_shares[i], b_shares[i])
            for i, (cid, _) in enumerate(self.roster)
        }
        # shares this client holds OF other clients' secrets:
        # subject_id -> (x, y_sk, y_b); seeded with its own
        my_sk, my_b = self._outgoing[client_id]
        self._held: Dict[str, Tuple[int, bytes, bytes]] = {
            client_id: (my_sk[0], my_sk[1], my_b[1])
        }
        self._masked = False
        self._revealed = False

    # -- phase 1: share distribution ---------------------------------------
    def make_share_uploads(self) -> List[Tuple[str, bytes]]:
        """Encrypted (to_client_id, ciphertext) bundles for every peer."""
        out = []
        for cid, pub in self.roster:
            if cid == self.client_id:
                continue
            (x, y_sk), (_, y_b) = self._outgoing[cid]
            key = sc.share_wrap_key(sc.dh_shared(self.sk, pub),
                                    self.round_number, self.roster_nonce)
            blob = sc.encrypt_share_bundle(
                key, sc.pack_share_pair(x, y_sk, y_b),
                aad=_aad(b"share", self.client_id, cid,
                         self.round_number, self.roster_nonce))
            out.append((cid, blob))
        return out

    def receive_shares(self, bundles: Sequence[Tuple[str, bytes]]) -> None:
        """Decrypt and store the bundles addressed to this client. Requires
        exactly one valid bundle from every peer (all-or-nothing: a missing
        share-phase peer means the roster must retry)."""
        my_x = self._index[self.client_id]
        for from_cid, blob in bundles:
            if from_cid not in self._pub or from_cid == self.client_id:
                raise ValueError(f"share from non-roster peer {from_cid}")
            key = sc.share_wrap_key(sc.dh_shared(self.sk,
                                                 self._pub[from_cid]),
                                    self.round_number, self.roster_nonce)
            pt = sc.decrypt_share_bundle(
                key, blob, aad=_aad(b"share", from_cid, self.client_id,
                                    self.round_number, self.roster_nonce))
            x, y_sk, y_b = sc.unpack_share_pair(pt)
            if x != my_x:
                raise ValueError(
                    f"share from {from_cid} carries x={x}, expected my "
                    f"roster index {my_x}")
            self._held[from_cid] = (x, y_sk, y_b)
        missing = set(self._index) - set(self._held)
        if missing:
            raise ValueError(f"missing shares from peers: {sorted(missing)}")

    # -- phase 2: masked upload ---------------------------------------------
    def _apply_masks(self, enc: np.ndarray) -> np.ndarray:
        """Add the self mask and the signed pairwise masks to an already
        integer-encoded flat payload (uint64 working dtype, mod 2^32);
        one-shot per roster freeze."""
        if self._masked:
            raise RuntimeError(
                "payload already masked under this roster — a second "
                "submission would reuse masks; wait for a roster retry")
        self._masked = True
        dim = int(enc.size)
        total = enc.astype(np.uint64)
        total = (total + sc.mask_stream_u32(
            sc.self_mask_seed(self.b, self.round_number, self.roster_nonce),
            dim)) % sc.MASK_DOMAIN
        for cid, pub in self.roster:
            if cid == self.client_id or cid not in self._neighbors:
                continue
            seed = sc.pair_mask_seed(sc.dh_shared(self.sk, pub),
                                     self.round_number, self.roster_nonce)
            m = sc.mask_stream_u32(seed, dim).astype(np.uint64)
            if self.client_id < cid:
                total = (total + m) % sc.MASK_DOMAIN
            else:
                total = (total + sc.MASK_DOMAIN - m) % sc.MASK_DOMAIN
        return total.astype(np.uint32)

    @staticmethod
    def _split_flat(total: np.ndarray, weights: Dict[str, np.ndarray],
                    keys) -> Dict[str, np.ndarray]:
        out, offset = {}, 0
        for k in keys:
            w = np.asarray(weights[k])
            out[k] = total[offset: offset + w.size].reshape(w.shape)
            offset += w.size
        return out

    def mask_payload(self, weights: Dict[str, np.ndarray],
                     num_samples: int) -> Dict[str, np.ndarray]:
        """``enc(n·θ) + PRG(b) + Σ ±PRG(s_ij) (mod 2^32)`` laid out layer by
        layer in sorted-key order, returned as uint32 arrays."""
        keys = _flat_order(weights)
        flat = np.concatenate(
            [np.asarray(weights[k], np.float64).ravel() for k in keys]
        ) * float(num_samples)
        enc = sc.fp_encode(flat, self.frac_bits,
                           headroom=len(self.roster))
        return self._split_flat(self._apply_masks(enc), weights, keys)

    def mask_integer_payload(self, int_weights: Dict[str, np.ndarray]
                             ) -> Dict[str, np.ndarray]:
        """Mask an ALREADY-INTEGER payload (uint32/int32 arrays on the
        mod-2^32 ring — e.g. a distributed-DP Skellam payload from
        fl.distributed_dp.host_client_integer_payload), skipping the
        fixed-point encode. The unmasked modular sum is recovered with
        :meth:`SecAggServerRound.unmask_integer_sum`."""
        keys = _flat_order(int_weights)
        for k in keys:
            a = np.asarray(int_weights[k])
            if a.dtype not in (np.dtype(np.uint32), np.dtype(np.int32)):
                raise ValueError(
                    f"integer payload leaf {k!r} has dtype {a.dtype}; "
                    "expected int32/uint32 (already on the mod-2^32 ring)")
        flat = np.concatenate(
            [np.asarray(int_weights[k]).ravel().astype(np.int64)
             % sc.MASK_DOMAIN for k in keys]).astype(np.uint32)
        return self._split_flat(self._apply_masks(flat), int_weights, keys)

    # -- phase 3: reveal ----------------------------------------------------
    def reveal(self, survivors: Sequence[str], dropped: Sequence[str]
               ) -> List[Tuple[str, bool, bytes]]:
        """Shares for the coordinator's reconstruction:
        (subject_id, is_key_share, x||y). One-shot, and refuses
        inconsistent survivor sets — revealing both kinds for one subject,
        or revealing under a sub-threshold survivor set, would let the
        coordinator unmask an individual."""
        if self._revealed:
            raise RuntimeError(
                "already revealed for this roster — a second reveal with a "
                "different survivor partition could expose both the key "
                "and self-mask shares of one subject")
        surv, drop = set(survivors), set(dropped)
        if surv & drop:
            raise ValueError("survivor/dropped sets overlap")
        if surv | drop != set(self._index):
            raise ValueError("survivors+dropped must partition the roster")
        if self.client_id not in surv:
            raise ValueError("refusing to reveal: this client is not "
                             "listed as a survivor")
        if len(surv) < self.threshold:
            raise ValueError(
                f"refusing to reveal: {len(surv)} survivors < threshold "
                f"{self.threshold}")
        # Isolation guard (round-4 adversarial review): if EVERY
        # pairing-graph neighbor of some survivor s is declared dropped,
        # honest reveals would hand the coordinator both s's self-mask
        # (s is a survivor) and every one of s's pair masks (reconstructed
        # from the dropped neighbors' keys) — s's individual payload would
        # be fully unmasked. The graph is deterministic from public
        # (roster, nonce), so every honest client detects the
        # targeted-dropout partition locally and aborts instead. The
        # t > 2n/3 threshold then ensures the coordinator can never gather
        # enough reveals for such a partition from honest clients.
        for s in sorted(surv):
            nbs = self._graph[s]
            if nbs and not (nbs & surv):
                raise ValueError(
                    f"refusing to reveal: survivor {s!r} is isolated — all "
                    "of its pairing-graph neighbors are declared dropped, "
                    "so revealing would unmask its individual payload "
                    "(targeted-dropout attack); the coordinator must drop "
                    "it from the sum instead")
        self._revealed = True
        out = []
        for subject in sorted(surv):
            x, _, y_b = self._held[subject]
            out.append((subject, False, x.to_bytes(2, "big") + y_b))
        for subject in sorted(drop):
            x, y_sk, _ = self._held[subject]
            out.append((subject, True, x.to_bytes(2, "big") + y_sk))
        return out


# ===========================================================================
# Server side
# ===========================================================================

class SecAggServerRound:
    """The coordinator's per-roster-freeze protocol state. Thread-safe via
    an internal lock (RPC handlers call from the gRPC worker pool)."""

    def __init__(self, round_number: int,
                 roster: Sequence[Tuple[str, bytes]],
                 threshold: Optional[int] = None,
                 frac_bits: int = sc.DEFAULT_FRAC_BITS):
        self.round_number = int(round_number)
        self.roster = sorted((cid, bytes(pub)) for cid, pub in roster)
        self.roster_ids = [cid for cid, _ in self.roster]
        self.nonce = secrets.token_bytes(16)
        self.neighbors = pair_neighbors(self.roster_ids, self.nonce)
        self.threshold = (int(threshold) if threshold
                          else default_threshold(len(self.roster)))
        if not 1 <= self.threshold <= len(self.roster):
            raise ValueError(f"threshold {self.threshold} invalid for "
                             f"roster of {len(self.roster)}")
        self.frac_bits = int(frac_bits)
        self._lock = threading.Lock()
        # phase 1
        self._by_recipient: Dict[str, List[Tuple[str, bytes]]] = {}
        self._share_senders: set = set()
        # phase 3
        self.survivors: Optional[List[str]] = None
        self.dropped: Optional[List[str]] = None
        self._reveals: Dict[str, List[Tuple[str, bool, bytes]]] = {}
        self.first_payload_time: Optional[float] = None

    # -- phase 1 ferry -------------------------------------------------------
    def add_share_upload(self, from_cid: str,
                         bundles: Sequence[Tuple[str, bytes]]) -> None:
        with self._lock:
            if from_cid not in self.roster_ids:
                raise ValueError(f"{from_cid} is not a roster member")
            if from_cid in self._share_senders:
                raise ValueError(f"{from_cid} already submitted shares for "
                                 "this roster")
            expected = set(self.roster_ids) - {from_cid}
            got = [to for to, _ in bundles]
            if sorted(got) != sorted(expected):
                raise ValueError(
                    f"share upload must address every peer exactly once: "
                    f"got {sorted(got)}, want {sorted(expected)}")
            for to_cid, blob in bundles:
                self._by_recipient.setdefault(to_cid, []).append(
                    (from_cid, bytes(blob)))
            self._share_senders.add(from_cid)

    def shares_ready(self) -> bool:
        with self._lock:
            return self._share_senders == set(self.roster_ids)

    def shares_for(self, cid: str) -> List[Tuple[str, bytes]]:
        with self._lock:
            return list(self._by_recipient.get(cid, ()))

    # -- phase 3 survivor freeze + reveals ------------------------------------
    def freeze_survivors(self, submitted_ids) -> None:
        with self._lock:
            if self.survivors is not None:
                return
            surv = set(submitted_ids) & set(self.roster_ids)
            # Liveness counterpart of the client-side isolation guard: a
            # survivor whose entire pairing-graph neighborhood dropped
            # cannot be included in the sum (honest clients refuse to
            # reveal such a partition — its payload would be unmaskable
            # individually). Move it to the dropped set instead: its
            # self-mask is then never revealed, so its payload stays
            # hidden, and its pair masks strip through the normal
            # dropped-key path. Cascade to a fixpoint (dropping one
            # client can isolate another).
            changed = True
            while changed:
                changed = False
                for s in sorted(surv):
                    nbs = self.neighbors[s]
                    if nbs and not (nbs & surv):
                        surv.discard(s)
                        changed = True
                        logger.warning(
                            "secagg round %d: survivor %s isolated by "
                            "dropouts — excluded from the sum to keep its "
                            "payload hidden", self.round_number, s)
            surv = sorted(surv)
            if len(surv) < self.threshold:
                raise ValueError(
                    f"only {len(surv)} masked payloads < threshold "
                    f"{self.threshold}: the round cannot be recovered")
            self.survivors = surv
            self.dropped = sorted(set(self.roster_ids) - set(surv))
            logger.info(
                "secagg round %d survivor set frozen: %d survivors, %d "
                "dropped %s", self.round_number, len(surv),
                len(self.dropped), self.dropped or "")

    def add_reveal(self, from_cid: str,
                   items: Sequence[Tuple[str, bool, bytes]]) -> None:
        with self._lock:
            if self.survivors is None:
                raise ValueError("survivor set not frozen yet")
            if from_cid not in self.survivors:
                raise ValueError(f"{from_cid} is not a survivor")
            if from_cid in self._reveals:
                raise ValueError(f"{from_cid} already revealed")
            surv, drop = set(self.survivors), set(self.dropped)
            for subject, is_key, _ in items:
                if is_key and subject not in drop:
                    raise ValueError(
                        f"key share revealed for non-dropped {subject}")
                if not is_key and subject not in surv:
                    raise ValueError(
                        f"self-mask share revealed for non-survivor "
                        f"{subject}")
            self._reveals[from_cid] = [(s, bool(k), bytes(b))
                                       for s, k, b in items]

    def can_unmask(self) -> bool:
        with self._lock:
            return (self.survivors is not None
                    and len(self._reveals) >= self.threshold)

    # -- phase 4 unmask -------------------------------------------------------
    def _reconstruct(self, subject: str, want_key: bool) -> bytes:
        shares = []
        for items in self._reveals.values():
            for s, is_key, blob in items:
                if s == subject and is_key == want_key:
                    shares.append((int.from_bytes(blob[:2], "big"),
                                   blob[2:]))
        if len(shares) < self.threshold:
            raise ValueError(
                f"only {len(shares)} shares for {subject} "
                f"(want_key={want_key}) < threshold {self.threshold}")
        return sc.shamir_reconstruct(shares[: self.threshold])

    def _stripped_modular_sum(self, updates: Sequence[ModelUpdate]):
        """Sum the survivors' masked payloads and strip self masks and the
        dropped clients' unpaired masks; returns the raw mod-2^32 sum as
        ``(total_u64, keys, shapes, survivors)``."""
        with self._lock:
            if self.survivors is None:
                raise ValueError("survivor set not frozen")
            survivors = list(self.survivors)
            dropped = list(self.dropped)
        by_id = {u.client_id: u for u in updates}
        missing = [cid for cid in survivors if cid not in by_id]
        if missing:
            raise ValueError(f"missing survivor payloads: {missing}")
        pubs = dict(self.roster)

        keys = _flat_order(by_id[survivors[0]].model_weights)
        shapes = {k: np.asarray(by_id[survivors[0]].model_weights[k]).shape
                  for k in keys}
        dim = int(sum(np.prod(shapes[k], dtype=np.int64) for k in keys))

        total = np.zeros(dim, np.uint64)
        for cid in survivors:
            w = by_id[cid].model_weights
            if _flat_order(w) != keys:
                raise ValueError(f"{cid} payload key set mismatch")
            flat = np.concatenate([
                np.asarray(w[k], np.uint32).ravel() for k in keys])
            if flat.size != dim:
                raise ValueError(f"{cid} payload size {flat.size} != {dim}")
            total = (total + flat.astype(np.uint64)) % sc.MASK_DOMAIN

        # strip survivors' self masks
        for cid in survivors:
            b = self._reconstruct(cid, want_key=False)
            m = sc.mask_stream_u32(
                sc.self_mask_seed(b, self.round_number, self.nonce),
                dim).astype(np.uint64)
            total = (total + sc.MASK_DOMAIN - m) % sc.MASK_DOMAIN

        # strip the survivors' unpaired masks toward dropped clients:
        # survivor k's payload contains sign(k, j)·PRG(s_kj) for dropped j
        # — only for k in j's pairing-graph neighborhood (SecAgg+)
        for j in dropped:
            sk_j = sc.private_key_from_bytes(
                self._reconstruct(j, want_key=True))
            for k in survivors:
                if k not in self.neighbors[j]:
                    continue
                seed = sc.pair_mask_seed(sc.dh_shared(sk_j, pubs[k]),
                                         self.round_number, self.nonce)
                m = sc.mask_stream_u32(seed, dim).astype(np.uint64)
                if k < j:   # survivor k added +m
                    total = (total + sc.MASK_DOMAIN - m) % sc.MASK_DOMAIN
                else:       # survivor k added -m
                    total = (total + m) % sc.MASK_DOMAIN
        return total, keys, shapes, survivors

    def unmask_aggregate(self, updates: Sequence[ModelUpdate]
                         ) -> GlobalModel:
        """Sum the survivors' masked payloads, strip self masks and the
        dropped clients' unpaired masks, decode the fixed-point weighted
        sum, and divide by Σn."""
        total, keys, shapes, survivors = self._stripped_modular_sum(updates)
        by_id = {u.client_id: u for u in updates}
        summed = sc.fp_decode_sum(total.astype(np.uint32), self.frac_bits)
        total_n = float(sum(by_id[cid].num_samples for cid in survivors))
        if total_n <= 0:
            raise ValueError("non-positive total sample count")

        averaged, offset = {}, 0
        for k in keys:
            size = int(np.prod(shapes[k], dtype=np.int64))
            averaged[k] = (summed[offset: offset + size] / total_n) \
                .astype(np.float32).reshape(shapes[k])
            offset += size
        return GlobalModel(
            round_number=self.round_number,
            model_weights=averaged,
            accuracy_metrics={},
            participating_clients=survivors,
            convergence_score=0.0,
        )

    def unmask_integer_sum(self, updates: Sequence[ModelUpdate]
                           ) -> Tuple[Dict[str, np.ndarray], List[str]]:
        """Integer-payload variant (distributed DP): strip the masks and
        return the raw per-layer mod-2^32 sums as uint32 arrays plus the
        survivor list — the caller decodes with the distributed-DP plan
        (``fl.distributed_dp.host_decode_average``), which owns the
        γ-grid and the fixed denominator."""
        total, keys, shapes, survivors = self._stripped_modular_sum(updates)
        out, offset = {}, 0
        u32 = total.astype(np.uint32)
        for k in keys:
            size = int(np.prod(shapes[k], dtype=np.int64))
            out[k] = u32[offset: offset + size].reshape(shapes[k])
            offset += size
        return out, survivors
