"""The port's secure-aggregation protocol (``fl_tpu_torch.services.
secagg_crypto`` and ``secagg_wire``) against the reference's, on the CPU.

- The primitives bit for bit: the ChaCha20 mask stream, the fixed-point
  codec, the seed and key derivations; Shamir shares and AES-GCM share
  bundles made by one package open in the other.
- A roster that MIXES port and reference client sessions, run through the
  port's and the reference's server round on the same nonce: the two
  unmasked aggregates are bit-equal, and equal to the deterministic
  fixed-point decode of the clients' plaintexts, with and without a
  dropout after the share phase, on the complete (n <= 16) and the sparse
  pairing graph.
- The integer (distributed-DP) payload: ``host_client_integer_payload``
  bit-equal in both packages for the same generator, and
  ``unmask_integer_sum`` / ``host_decode_average`` bit-equal.
- The reference's refusals, message for message.
"""

import types

import numpy as np
import pytest
import torch

from fl_tpu.core import types as jtypes
from fl_tpu.fl import distributed_dp as jddp
from fl_tpu.services import grpc_server as jgs
from fl_tpu.services import secagg_crypto as jsc
from fl_tpu.services import secagg_wire as jsw
from fl_tpu_torch.core import types as ttypes
from fl_tpu_torch.fl import distributed_dp as tddp
from fl_tpu_torch.services import grpc_server as tgs
from fl_tpu_torch.services import secagg_crypto as tsc
from fl_tpu_torch.services import secagg_wire as tsw

PORT = types.SimpleNamespace(name="port", sc=tsc, sw=tsw, types=ttypes,
                             ddp=tddp, gs=tgs)
REF = types.SimpleNamespace(name="reference", sc=jsc, sw=jsw, types=jtypes,
                            ddp=jddp, gs=jgs)
PACKAGES = [PORT, REF]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raised(fn):
    """(type name, message) of what ``fn()`` raises."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)
    raise AssertionError("expected a refusal")


def _same_refusal(make, match=None):
    """``make(pkg)`` refuses in both packages with the same type and
    message."""
    got = _raised(lambda: make(PORT))
    want = _raised(lambda: make(REF))
    assert got == want
    if match is not None:
        assert match in got[1], got
    return got


# --- the primitives ------------------------------------------------------------

@pytest.mark.parametrize("dim", [0, 1, 7, 4099])
def test_mask_stream_equals_the_reference(dim):
    rng = np.random.default_rng(dim)
    for _ in range(3):
        seed = rng.bytes(32)
        got = tsc.mask_stream_u32(seed, dim)
        want = jsc.mask_stream_u32(seed, dim)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    assert _same_refusal(lambda p: p.sc.mask_stream_u32(b"x" * 31, 4))


@pytest.mark.parametrize("frac_bits,headroom", [(16, 1), (16, 8), (12, 3),
                                                (20, 64)])
def test_fixed_point_codec_equals_the_reference(frac_bits, headroom):
    rng = np.random.default_rng(frac_bits + headroom)
    limit = 2.0 ** 31 / headroom / 2.0 ** frac_bits
    x = rng.uniform(-0.999 * limit, 0.999 * limit, 5000)
    x[:4] = [0.0, -0.0, 0.5 / 2 ** frac_bits, -1.5 / 2 ** frac_bits]
    for arr in (x, x.astype(np.float32), x.reshape(50, 100)):
        got = tsc.fp_encode(arr, frac_bits, headroom)
        want = jsc.fp_encode(arr, frac_bits, headroom)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tsc.fp_decode_sum(got, frac_bits),
                                      jsc.fp_decode_sum(want, frac_bits))
    summed = (tsc.fp_encode(x[:100], frac_bits, headroom).astype(np.uint64)
              * 3) % tsc.MASK_DOMAIN
    np.testing.assert_array_equal(tsc.fp_decode_sum(summed, frac_bits),
                                  jsc.fp_decode_sum(summed, frac_bits))
    assert tsc.fp_encode(np.zeros(0)).size == 0


def test_seed_and_key_derivations_equal_the_reference():
    rng = np.random.default_rng(5)
    for rn in (0, 7, 123456):
        shared, nonce, b = rng.bytes(32), rng.bytes(16), rng.bytes(32)
        assert tsc.pair_mask_seed(shared, rn, nonce) == \
            jsc.pair_mask_seed(shared, rn, nonce)
        assert tsc.self_mask_seed(b, rn, nonce) == \
            jsc.self_mask_seed(b, rn, nonce)
        assert tsc.share_wrap_key(shared, rn, nonce) == \
            jsc.share_wrap_key(shared, rn, nonce)
    assert tsc.PRIME == jsc.PRIME and tsc.MASK_DOMAIN == jsc.MASK_DOMAIN
    assert tsc.DEFAULT_FRAC_BITS == jsc.DEFAULT_FRAC_BITS
    # X25519 across packages: either side's keys agree on the secret
    tk, tp = tsc.generate_keypair()
    jk, jp = jsc.generate_keypair()
    assert tsc.dh_shared(tk, jp) == jsc.dh_shared(jk, tp)
    raw = tsc.private_key_bytes(tk)
    assert jsc.private_key_bytes(jsc.private_key_from_bytes(raw)) == raw


@pytest.mark.parametrize("split,join", [(PORT, REF), (REF, PORT)],
                         ids=["port-split", "reference-split"])
def test_shamir_shares_reconstruct_in_the_other_package(split, join):
    rng = np.random.default_rng(11)
    for n, t in ((1, 1), (5, 3), (9, 6), (20, 14)):
        secret = rng.bytes(32)
        shares = split.sc.shamir_split(secret, n, t)
        for _ in range(3):
            pick = sorted(rng.choice(n, size=t, replace=False))
            sub = [shares[i] for i in pick]
            assert join.sc.shamir_reconstruct(sub) == secret
    short = split.sc.shamir_split(b"\x01" * 32, 4, 2)
    assert _raised(lambda: join.sc.shamir_reconstruct(
        [short[0], short[0]])) == ("ValueError",
                                   "duplicate share x-coordinates")


@pytest.mark.parametrize("seal,open_", [(PORT, REF), (REF, PORT)],
                         ids=["port-seals", "reference-seals"])
def test_share_bundles_open_in_the_other_package(seal, open_):
    rng = np.random.default_rng(2)
    key, aad = rng.bytes(32), b"share|a|b|3|00"
    y_key, y_seed = rng.bytes(66), rng.bytes(66)
    blob = seal.sc.encrypt_share_bundle(
        key, seal.sc.pack_share_pair(17, y_key, y_seed), aad)
    x, yk, ys = open_.sc.unpack_share_pair(
        open_.sc.decrypt_share_bundle(key, blob, aad))
    assert (x, yk, ys) == (17, y_key, y_seed)
    tampered = blob[:-1] + bytes([blob[-1] ^ 1])
    with pytest.raises(Exception):
        open_.sc.decrypt_share_bundle(key, tampered, aad)
    with pytest.raises(Exception):
        open_.sc.decrypt_share_bundle(key, blob, aad + b"x")


# --- a mixed roster through both packages' server rounds -------------------------

def _mixed_parties(n, threshold, rn=5, nonce_from=PORT):
    """A roster of ``n`` whose even members run the port's client session
    and odd members the reference's; the port's and the reference's server
    round on the same roster, nonce and threshold. The share phase is
    ferried by the first. Returns (ids, {pkg name: server}, sessions)."""
    ids = sorted(f"c{i:02d}" for i in range(n))
    pkg_of = {cid: PACKAGES[i % 2] for i, cid in enumerate(ids)}
    keys = {cid: pkg_of[cid].sc.generate_keypair() for cid in ids}
    roster = [(cid, keys[cid][1]) for cid in ids]
    first = nonce_from.sw.SecAggServerRound(rn, roster, threshold=threshold)
    servers = {nonce_from.name: first}
    for pkg in PACKAGES:
        if pkg is not nonce_from:
            other = pkg.sw.SecAggServerRound(rn, roster, threshold=threshold)
            other.nonce = first.nonce
            other.neighbors = pkg.sw.pair_neighbors(other.roster_ids,
                                                    other.nonce)
            servers[pkg.name] = other
    assert servers["port"].neighbors == servers["reference"].neighbors
    sessions = {
        cid: pkg_of[cid].sw.SecAggClientSession(
            cid, keys[cid][0], rn, first.roster, first.nonce,
            first.threshold, first.frac_bits)
        for cid in ids
    }
    for cid in ids:
        first.add_share_upload(cid, sessions[cid].make_share_uploads())
    assert first.shares_ready()
    for cid in ids:
        sessions[cid].receive_shares(first.shares_for(cid))
    return ids, servers, sessions


def _reveal_into(servers, sessions, survivors):
    """Freeze ``survivors`` on every server and hand each survivor's one
    reveal to all of them."""
    for srv in servers.values():
        srv.freeze_survivors(survivors)
    first = next(iter(servers.values()))
    assert all(srv.survivors == first.survivors
               and srv.dropped == first.dropped for srv in servers.values())
    for cid in first.survivors:
        items = sessions[cid].reveal(first.survivors, first.dropped)
        for srv in servers.values():
            srv.add_reveal(cid, items)
    return first.survivors


def _fixed_point_mean(plain, n, survivors, frac_bits=16):
    """The deterministic decode of the survivors' plaintexts: the sum of
    round(n_i θ_i 2^f) as a centered int over 2^f, divided by Σn, in f32."""
    keys = sorted(plain[survivors[0]])
    out, total = {}, float(sum(n[c] for c in survivors))
    for k in keys:
        acc = sum(np.round(np.asarray(plain[c][k], np.float64)
                           * n[c] * (1 << frac_bits)).astype(np.int64)
                  for c in survivors)
        out[k] = (acc.astype(np.float64) / float(1 << frac_bits)
                  / total).astype(np.float32)
    return out


@pytest.mark.parametrize("n,threshold", [(4, 3), (20, 14)],
                         ids=["complete", "sparse"])
@pytest.mark.parametrize("drop", [False, True], ids=["all", "one-dropout"])
@pytest.mark.parametrize("nonce_from", PACKAGES, ids=["port", "reference"])
def test_mixed_roster_unmasks_bit_equal(n, threshold, drop, nonce_from):
    ids, servers, sessions = _mixed_parties(n, threshold,
                                            nonce_from=nonce_from)
    if n > 16:
        k = tsw.pair_graph_degree(n)
        assert all(len(s._neighbors) == k for s in sessions.values())
    rng = np.random.default_rng(n + drop)
    plain = {cid: {"w": rng.normal(0, 0.2, (6, 4)).astype(np.float32),
                   "b": rng.normal(0, 0.2, (4,)).astype(np.float32)}
             for cid in ids}
    n_samples = {cid: 10 + 7 * i for i, cid in enumerate(ids)}
    dead = ids[1] if drop else None
    updates = {pkg.name: [] for pkg in PACKAGES}
    for cid in ids:
        masked = sessions[cid].mask_payload(plain[cid], n_samples[cid])
        assert masked["w"].dtype == np.uint32
        if cid == dead:
            continue  # died after masking: the payload never arrived
        for pkg in PACKAGES:
            updates[pkg.name].append(pkg.types.ModelUpdate(
                client_id=cid, round_number=5, model_weights=masked,
                num_samples=n_samples[cid], training_loss=0.0))
    survivors = _reveal_into(servers, sessions,
                             [c for c in ids if c != dead])
    assert servers["port"].dropped == ([dead] if drop else [])
    got = servers["port"].unmask_aggregate(updates["port"])
    want = servers["reference"].unmask_aggregate(updates["reference"])
    assert got.participating_clients == want.participating_clients == \
        survivors
    expect = _fixed_point_mean(plain, n_samples, survivors)
    for k in ("w", "b"):
        assert got.model_weights[k].dtype == np.float32
        np.testing.assert_array_equal(got.model_weights[k],
                                      want.model_weights[k])
        np.testing.assert_array_equal(got.model_weights[k], expect[k])


@pytest.mark.parametrize("drop", [False, True], ids=["all", "one-dropout"])
def test_integer_sum_equals_the_reference(drop):
    plan_args = (1.0, 12, 28, 4, 1.5)
    tplan, jplan = tddp.DistributedDPPlan(*plan_args), \
        jddp.DistributedDPPlan(*plan_args)
    ids, servers, sessions = _mixed_parties(4, 3, rn=9)
    rng = np.random.default_rng(21)
    delta = {cid: {"w": rng.normal(0, 0.3, (6, 4)).astype(np.float32),
                   "b": rng.normal(0, 0.3, (4,)).astype(np.float32)}
             for cid in ids}
    dead = ids[2] if drop else None
    updates = {pkg.name: [] for pkg in PACKAGES}
    for i, cid in enumerate(ids):
        got = tddp.host_client_integer_payload(
            delta[cid], tplan, np.random.default_rng(100 + i))
        want = jddp.host_client_integer_payload(
            delta[cid], jplan, np.random.default_rng(100 + i))
        for k in want:
            assert got[k].dtype == want[k].dtype == np.uint32
            np.testing.assert_array_equal(got[k], want[k])
        masked = sessions[cid].mask_integer_payload(got)
        if cid == dead:
            continue
        for pkg in PACKAGES:
            updates[pkg.name].append(pkg.types.ModelUpdate(
                client_id=cid, round_number=9, model_weights=masked,
                num_samples=1, training_loss=0.0))
    survivors = _reveal_into(servers, sessions,
                             [c for c in ids if c != dead])
    tsum, tsurv = servers["port"].unmask_integer_sum(updates["port"])
    jsum, jsurv = servers["reference"].unmask_integer_sum(
        updates["reference"])
    assert tsurv == jsurv == survivors
    tavg = tddp.host_decode_average(tsum, tplan)
    javg = jddp.host_decode_average(jsum, jplan)
    for k in jsum:
        np.testing.assert_array_equal(tsum[k], jsum[k])
        np.testing.assert_array_equal(tavg[k], javg[k])
    assert tddp.distributed_epsilon(tplan, 1, 1e-5,
                                    realized=len(survivors)) == \
        jddp.distributed_epsilon(jplan, 1, 1e-5, realized=len(survivors))


# --- the reference's refusals, message for message --------------------------------

def _parties(pkg, n=3, threshold=None, rn=5, share=True):
    """One package's roster (ids, server, sessions), shares exchanged."""
    ids = sorted(f"c{i}" for i in range(n))
    keys = {cid: pkg.sc.generate_keypair() for cid in ids}
    srv = pkg.sw.SecAggServerRound(rn, [(cid, keys[cid][1]) for cid in ids],
                                   threshold=threshold)
    sessions = {cid: pkg.sw.SecAggClientSession(
        cid, keys[cid][0], rn, srv.roster, srv.nonce, srv.threshold,
        srv.frac_bits) for cid in ids}
    if share:
        for cid in ids:
            srv.add_share_upload(cid, sessions[cid].make_share_uploads())
        for cid in ids:
            sessions[cid].receive_shares(srv.shares_for(cid))
    return ids, srv, sessions


def _w():
    return {"w": np.full((3, 2), 0.25, np.float32)}


def test_sub_threshold_survivors_are_refused():
    def server(p):
        _, srv, _ = _parties(p, 4, threshold=3)
        srv.freeze_survivors(["c0", "c1"])

    def client(p):
        _, srv, s = _parties(p, 4, threshold=3)
        s["c0"].reveal(["c0", "c1"], ["c2", "c3"])

    _same_refusal(server, "only 2 masked payloads < threshold 3")
    _same_refusal(client, "2 survivors < threshold 3")


def test_double_mask_and_double_reveal_are_refused():
    def mask(p):
        _, _, s = _parties(p)
        s["c0"].mask_payload(_w(), 1)
        s["c0"].mask_payload(_w(), 1)

    def mask_int(p):
        _, _, s = _parties(p)
        s["c0"].mask_payload(_w(), 1)
        s["c0"].mask_integer_payload({"w": np.zeros(3, np.uint32)})

    def reveal(p):
        ids, _, s = _parties(p)
        s["c0"].reveal(ids, [])
        s["c0"].reveal(ids, [])

    _same_refusal(mask, "already masked")
    _same_refusal(mask_int, "already masked")
    _same_refusal(reveal, "already revealed")


@pytest.mark.parametrize("survivors,dropped,match", [
    (["c0", "c1"], ["c1", "c2"], "overlap"),
    (["c0", "c1"], [], "partition the roster"),
    (["c1", "c2"], ["c0"], "not listed as a survivor"),
], ids=["overlap", "not-a-partition", "not-a-survivor"])
def test_inconsistent_survivor_sets_are_refused(survivors, dropped, match):
    def reveal(p):
        _, _, s = _parties(p, threshold=2)
        s["c0"].reveal(survivors, dropped)

    _same_refusal(reveal, match)


def test_isolating_partition_is_refused_and_cascaded():
    ids = sorted(f"c{i:02d}" for i in range(48))
    nonce = b"\x05" * 16
    graph = tsw.pair_neighbors(ids, nonce)
    assert graph == jsw.pair_neighbors(ids, nonce)
    assert [tsw.pair_graph_degree(n) for n in (3, 16, 17, 64, 512)] == \
        [jsw.pair_graph_degree(n) for n in (3, 16, 17, 64, 512)]
    victim = ids[7]
    dropped = sorted(graph[victim])
    revealer = next(c for c in ids if c != victim and c not in dropped)
    survivors = [c for c in ids if c not in dropped]

    def reveal(p):
        keys = {cid: p.sc.generate_keypair() for cid in ids}
        roster = [(cid, keys[cid][1]) for cid in ids]
        srv = p.sw.SecAggServerRound(9, roster)
        sess = p.sw.SecAggClientSession(revealer, keys[revealer][0], 9,
                                        srv.roster, nonce, srv.threshold)
        sess.reveal(survivors, dropped)

    _same_refusal(reveal, "is isolated")
    # the server's freeze moves the isolated survivor to the dropped set,
    # identically in both packages on one nonce
    frozen = []
    for p in PACKAGES:
        srv = p.sw.SecAggServerRound(
            9, [(cid, p.sc.generate_keypair()[1]) for cid in ids])
        srv.nonce = nonce
        srv.neighbors = graph
        srv.freeze_survivors(
            [c for c in ids if c not in graph[ids[3]]])
        frozen.append((srv.survivors, srv.dropped))
    assert frozen[0] == frozen[1] and ids[3] in frozen[0][1]


@pytest.mark.parametrize("case", ["non-roster", "twice", "addressing",
                                  "client-non-roster", "short-bundle",
                                  "bad-y", "session-roster"])
def test_malformed_shares_are_refused(case):
    def make(p):
        ids, srv, s = _parties(p, share=False)
        up = s["c0"].make_share_uploads()
        if case == "non-roster":
            srv.add_share_upload("zz", up)
        elif case == "twice":
            srv.add_share_upload("c0", up)
            srv.add_share_upload("c0", up)
        elif case == "addressing":
            srv.add_share_upload("c0", up[:1])
        elif case == "client-non-roster":
            s["c1"].receive_shares([("zz", up[0][1])])
        elif case == "short-bundle":
            p.sc.unpack_share_pair(b"\x00" * 10)
        elif case == "bad-y":
            p.sc.pack_share_pair(1, b"\x00" * 65, b"\x00" * 66)
        else:
            p.sw.SecAggClientSession("zz", None, 5, srv.roster, srv.nonce, 2)

    _same_refusal(make)


@pytest.mark.parametrize("case", ["key-for-survivor", "mask-for-dropped",
                                  "not-frozen", "non-survivor", "twice"])
def test_wrong_kind_reveals_are_refused(case):
    def make(p):
        ids, srv, s = _parties(p, 3, threshold=2)
        if case == "not-frozen":
            srv.add_reveal("c0", [])
        srv.freeze_survivors(["c0", "c1"])
        if case == "key-for-survivor":
            srv.add_reveal("c0", [("c1", True, b"\x00\x01")])
        elif case == "mask-for-dropped":
            srv.add_reveal("c0", [("c2", False, b"\x00\x01")])
        elif case == "non-survivor":
            srv.add_reveal("c2", [])
        else:
            srv.add_reveal("c0", [])
            srv.add_reveal("c0", [])

    _same_refusal(make)


def test_fixed_point_overflow_and_integer_dtype_are_refused():
    def overflow(p):
        _, _, s = _parties(p, 8, threshold=6)
        s["c0"].mask_payload({"w": np.full(4, 3.0, np.float32)}, 1500)

    def dtype(p):
        _, _, s = _parties(p)
        s["c0"].mask_integer_payload({"w": np.zeros((2, 2), np.float32)})

    _same_refusal(overflow, "fixed-point overflow risk")
    _same_refusal(dtype, "expected int32/uint32")
    _same_refusal(lambda p: p.sc.fp_encode(np.array([1e9]), 16, 1),
                  "fixed-point overflow risk")
    _same_refusal(lambda p: p.sc.shamir_split(b"\x00" * 33, 3, 2),
                  "secret too large")
    _same_refusal(lambda p: p.sc.shamir_split(b"\x00" * 32, 3, 4),
                  "threshold t=4")


def test_int32_wraparound_in_the_plan_is_refused():
    def servicer(p):
        kw = {"device": "cpu"} if p is PORT else {}
        return p.gs.FederatedLearningServicer(
            round_config=p.types.RoundConfig(
                privacy_config=p.types.PrivacyConfig(
                    1.0, 1e-5, max_grad_norm=1.0, noise_multiplier=0.3)),
            secure_aggregation=True, distributed_dp=True, ddp_bits=20,
            **kw)

    tplan = servicer(PORT)._ddp_plan(dim=421_770, roster_len=16)
    jplan = servicer(REF)._ddp_plan(dim=421_770, roster_len=16)
    assert (tplan.gamma, tplan.mu_local) == (jplan.gamma, jplan.mu_local)
    _same_refusal(lambda p: servicer(p)._ddp_plan(dim=421_770,
                                                  roster_len=4096),
                  "distributed-DP overflow risk")
