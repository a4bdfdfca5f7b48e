"""Cryptographic primitives for wire secure aggregation (port of
``fl_tpu.services.secagg_crypto``).

The building blocks of Bonawitz et al., CCS'17 ("Practical Secure
Aggregation for Privacy-Preserving Machine Learning") used by
``services.secagg_wire``:

- **Shamir t-of-n secret sharing** over the Mersenne prime field
  GF(2^521 - 1): large enough to share 32-byte secrets (X25519 private
  keys, self-mask seeds) as single field elements, with coefficients drawn
  from the OS CSPRNG;
- **mask PRG**: a ChaCha20 keystream expanded into a uint32 vector. Masks
  are uniform mod 2^32, so masking is perfectly hiding and cancellation is
  exact (no float rounding residue);
- **fixed-point codec**: weights enter the masked domain as
  ``round(x · 2^frac_bits) mod 2^32``; the aggregate decodes by centered
  interpretation, so correctness needs ``|Σ n_i θ_i| · 2^frac_bits < 2^31``
  per coordinate. ``fp_encode`` enforces the per-client slice of that
  bound and refuses payloads that could wrap;
- **share transport encryption**: AES-GCM under a pairwise X25519-derived
  key, so the coordinator ferries Shamir shares it cannot read.

The protocol is host work on numpy, as in the reference: the ring
arithmetic is uint32/uint64, which torch barely has, and the payload is
already on the host when it is masked. ``cryptography`` is imported where
it is first needed. Every constant and domain-separation string is the
reference's, so a port session and a reference session interoperate in
one roster.
"""

from __future__ import annotations

import hashlib
import secrets
from typing import List, Sequence, Tuple

import numpy as np

# GF(P): Mersenne prime 2^521 - 1 — field elements comfortably hold any
# 256-bit secret, and mod-P reduction is cheap for Python bigints.
PRIME = (1 << 521) - 1
_Y_BYTES = 66  # ceil(521 / 8)
SECRET_BYTES = 32

MASK_DOMAIN = 1 << 32
DEFAULT_FRAC_BITS = 16


# --------------------------------------------------------------------------
# Shamir t-of-n over GF(PRIME)
# --------------------------------------------------------------------------

def shamir_split(secret: bytes, n: int, t: int) -> List[Tuple[int, bytes]]:
    """Split a <=32-byte secret into n shares with reconstruction
    threshold t. Returns [(x, y_bytes)] with x in 1..n."""
    if not 1 <= t <= n:
        raise ValueError(f"threshold t={t} must satisfy 1 <= t <= n={n}")
    if len(secret) > SECRET_BYTES:
        raise ValueError(f"secret too large: {len(secret)} > {SECRET_BYTES}")
    s = int.from_bytes(secret.rjust(SECRET_BYTES, b"\0"), "big")
    coeffs = [s] + [secrets.randbelow(PRIME) for _ in range(t - 1)]
    shares = []
    for x in range(1, n + 1):
        # Horner evaluation of f(x) mod P
        y = 0
        for c in reversed(coeffs):
            y = (y * x + c) % PRIME
        shares.append((x, y.to_bytes(_Y_BYTES, "big")))
    return shares


def shamir_reconstruct(shares: Sequence[Tuple[int, bytes]]) -> bytes:
    """Lagrange-interpolate f(0) from >= t distinct shares; returns the
    32-byte secret. Raises on duplicate x or a value outside the 256-bit
    secret space (corrupt/insufficient shares)."""
    pts = [(int(x), int.from_bytes(y, "big")) for x, y in shares]
    xs = [x for x, _ in pts]
    if len(set(xs)) != len(xs):
        raise ValueError("duplicate share x-coordinates")
    acc = 0
    for i, (xi, yi) in enumerate(pts):
        num = den = 1
        for j, (xj, _) in enumerate(pts):
            if i == j:
                continue
            num = (num * (-xj)) % PRIME
            den = (den * (xi - xj)) % PRIME
        acc = (acc + yi * num * pow(den, PRIME - 2, PRIME)) % PRIME
    if acc >> (8 * SECRET_BYTES):
        raise ValueError(
            "reconstructed value exceeds the secret space — shares are "
            "corrupt, inconsistent, or fewer than the threshold")
    return acc.to_bytes(SECRET_BYTES, "big")


# --------------------------------------------------------------------------
# Mask PRG: ChaCha20 keystream -> uint32 vector (uniform mod 2^32)
# --------------------------------------------------------------------------

def mask_stream_u32(seed: bytes, dim: int) -> np.ndarray:
    """Expand a 32-byte seed into a uint32 mask vector of length ``dim``
    via the ChaCha20 keystream (key = seed, zero nonce — every seed is
    unique per (pair/self, round, roster nonce), so the nonce never
    repeats under one key)."""
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms

    if len(seed) != 32:
        raise ValueError(f"seed must be 32 bytes, got {len(seed)}")
    enc = Cipher(algorithms.ChaCha20(seed, b"\0" * 16), mode=None).encryptor()
    stream = enc.update(b"\0" * (4 * dim))
    return np.frombuffer(stream, dtype="<u4").copy()


# --------------------------------------------------------------------------
# Fixed-point codec (mod 2^32)
# --------------------------------------------------------------------------

def fp_encode(arr: np.ndarray, frac_bits: int = DEFAULT_FRAC_BITS,
              headroom: int = 1) -> np.ndarray:
    """``round(arr · 2^frac_bits) mod 2^32`` as uint32.

    ``headroom`` is the number of payloads this one will be SUMMED with
    (roster size): decoding the aggregate is only unambiguous while the
    summed fixed-point magnitude stays below 2^31, so each client's
    contribution must satisfy ``|x|·2^frac_bits < 2^31 / headroom``.
    Raises ValueError when the payload could make the aggregate wrap."""
    scaled = np.round(np.asarray(arr, np.float64) * (1 << frac_bits))
    limit = float(1 << 31) / max(1, int(headroom))
    worst = float(np.abs(scaled).max()) if scaled.size else 0.0
    if worst >= limit:
        raise ValueError(
            f"fixed-point overflow risk: |x|·2^{frac_bits} = {worst:.3g} "
            f">= 2^31/{headroom} = {limit:.3g}; lower the payload "
            f"magnitude or frac_bits")
    return scaled.astype(np.int64).astype(np.uint32)


def fp_decode_sum(arr_u32: np.ndarray,
                  frac_bits: int = DEFAULT_FRAC_BITS) -> np.ndarray:
    """Centered decode of an (unmasked) mod-2^32 SUM back to float64:
    values >= 2^31 are negative."""
    v = np.asarray(arr_u32, np.uint32).astype(np.int64)
    v = np.where(v >= (1 << 31), v - MASK_DOMAIN, v)
    return v.astype(np.float64) / float(1 << frac_bits)


# --------------------------------------------------------------------------
# X25519 key agreement + derived keys
# --------------------------------------------------------------------------

def generate_keypair():
    """X25519 keypair; returns (private_key_object, public_bytes(32))."""
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
    )

    sk = X25519PrivateKey.generate()
    pk = sk.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw
    )
    return sk, pk


def private_key_bytes(sk) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return sk.private_bytes(
        serialization.Encoding.Raw, serialization.PrivateFormat.Raw,
        serialization.NoEncryption(),
    )


def private_key_from_bytes(raw: bytes):
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
    )

    return X25519PrivateKey.from_private_bytes(raw)


def dh_shared(sk, peer_pub: bytes) -> bytes:
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PublicKey,
    )

    return sk.exchange(X25519PublicKey.from_public_bytes(peer_pub))


def _h(context: bytes, *parts: bytes) -> bytes:
    d = hashlib.sha256(context)
    for p in parts:
        d.update(len(p).to_bytes(4, "big"))
        d.update(p)
    return d.digest()


def pair_mask_seed(shared: bytes, round_number: int,
                   roster_nonce: bytes) -> bytes:
    """Mask seed for one (pair, round, roster-freeze): folding the freeze
    nonce in guarantees fresh masks on every all-or-retry re-freeze even
    under the same round number."""
    return _h(b"fl_tpu-secagg-v2-pairmask", shared,
              str(round_number).encode(), roster_nonce)


def self_mask_seed(b: bytes, round_number: int, roster_nonce: bytes) -> bytes:
    return _h(b"fl_tpu-secagg-v2-selfmask", b,
              str(round_number).encode(), roster_nonce)


def share_wrap_key(shared: bytes, round_number: int,
                   roster_nonce: bytes) -> bytes:
    return _h(b"fl_tpu-secagg-v2-sharekey", shared,
              str(round_number).encode(), roster_nonce)


# --------------------------------------------------------------------------
# Share-bundle transport: AES-GCM, coordinator-opaque
# --------------------------------------------------------------------------

def encrypt_share_bundle(key: bytes, plaintext: bytes, aad: bytes) -> bytes:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    nonce = secrets.token_bytes(12)
    return nonce + AESGCM(key).encrypt(nonce, plaintext, aad)


def decrypt_share_bundle(key: bytes, blob: bytes, aad: bytes) -> bytes:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    if len(blob) < 13:
        raise ValueError("ciphertext too short")
    return AESGCM(key).decrypt(blob[:12], blob[12:], aad)


def pack_share_pair(x: int, y_key: bytes, y_seed: bytes) -> bytes:
    """One peer's bundle: the Shamir x-coordinate plus this peer's share of
    (DH secret key, self-mask seed)."""
    if len(y_key) != _Y_BYTES or len(y_seed) != _Y_BYTES:
        raise ValueError("malformed share y values")
    return x.to_bytes(2, "big") + y_key + y_seed


def unpack_share_pair(blob: bytes) -> Tuple[int, bytes, bytes]:
    if len(blob) != 2 + 2 * _Y_BYTES:
        raise ValueError(f"share bundle must be {2 + 2 * _Y_BYTES} bytes, "
                         f"got {len(blob)}")
    x = int.from_bytes(blob[:2], "big")
    return x, blob[2:2 + _Y_BYTES], blob[2 + _Y_BYTES:]
