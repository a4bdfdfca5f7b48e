"""Client-side federated trainer: the deployment-mode round loop (port of
``fl_tpu.services.federated_trainer``).

Parity target: src/client/federated_trainer.py — the ClientState FSM
(:29-41: IDLE→CONNECTING→REGISTERED→WAITING_FOR_ROUND→DOWNLOADING_MODEL→
TRAINING→APPLYING_PRIVACY→UPLOADING_UPDATE→ROUND_COMPLETE/ERROR) and
FederatedTrainer (:43-589), which composes model + trainer + DP +
compression + data + gRPC.

The compute path runs on the trainer's device (the card unless
``device="cpu"``): one client's local training is the round engines' own
``fl.local_training.make_local_train_fn`` at one client, and its delta-DP
release is ``fl.privacy.clip_and_noise_tree``, one (1, D) row through the
clip+noise kernel (K3 on a card). Under secure aggregation that release
stays on K3 and the noised weights are then masked on the host
(``services.secagg_wire``; masking is post-processing); under distributed
DP the release is the integer pipeline on the host instead (clip, γ-grid,
Skellam share, mask), and K3 does not run. The reference's hardcoded 0.8
compression ratio (federated_trainer.py:484: the service is constructed
but never applied) is not reproduced: the ratio reported is the one the
configured compression actually reaches on the upload.

Random streams: the shuffle and dropout of round r descend from a root
seed that is a digest of the public client id (a restarted client replays
them), every DP draw from a SECRET root (``dp_noise_secret``, a
``dp_secret_path`` file or ``os.urandom``): root → round → client index →
``DP_NOISE`` (``DISTRIBUTED_DP`` for the Skellam share).

``grpcio`` and ``protobuf`` are not needed to import this module or to
construct a trainer: the gRPC client imports them at its first RPC.
``cryptography`` is needed from the first secure round on (the keypair is
drawn at construction).
"""

from __future__ import annotations

import enum
import hashlib
import hmac
import logging
import math
import os
import pathlib
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from fl_tpu_torch.core import prng
from fl_tpu_torch.core.mesh import resolve_device
from fl_tpu_torch.core.pytree import tree_map
from fl_tpu_torch.core.types import (
    ClientCapabilities,
    ComputePowerLevel,
    ModelUpdate,
    PrivacyConfig,
    TrainingMetrics,
    to_numpy,
)
from fl_tpu_torch.fl.compression import create_compression_service
from fl_tpu_torch.fl.distributed_dp import (
    DistributedDPPlan,
    distributed_epsilon,
    host_client_integer_payload,
)
from fl_tpu_torch.fl.local_training import (
    FederatedTrainingConfig,
    create_adaptive_config,
    make_local_train_fn,
    train_variables,
)
from fl_tpu_torch.fl.privacy import (
    PrivacyBudgetTracker,
    adaptive_clip_delta_multiplier,
    clip_and_noise_tree,
    clip_and_noise_tree_at_sigma,
)
from fl_tpu_torch.models import get_model_for_dataset
from fl_tpu_torch.models.factory import (
    get_model_weights,
    init_variables,
    set_model_weights,
)
from fl_tpu_torch.services.secagg_wire import (
    PUBKEY_METADATA_KEY,
    SecAggClientSession,
)

logger = logging.getLogger(__name__)


class ClientState(enum.Enum):
    """ref: ClientState, federated_trainer.py:29-41."""

    IDLE = "idle"
    CONNECTING = "connecting"
    REGISTERED = "registered"
    WAITING_FOR_ROUND = "waiting_for_round"
    DOWNLOADING_MODEL = "downloading_model"
    TRAINING = "training"
    APPLYING_PRIVACY = "applying_privacy"
    UPLOADING_UPDATE = "uploading_update"
    ROUND_COMPLETE = "round_complete"
    ERROR = "error"
    STOPPED = "stopped"


class FederatedTrainer:
    """ref: FederatedTrainer, federated_trainer.py:43-589. ``device``:
    where the client trains and releases; None is the card."""

    def __init__(
        self,
        client_id: str,
        coordinator_host: str = "localhost",
        coordinator_port: int = 50051,
        dataset: str = "mnist",
        model_name: Optional[str] = None,
        capabilities: Optional[ClientCapabilities] = None,
        privacy: Optional[PrivacyConfig] = None,
        epsilon_per_round: Optional[float] = None,
        delta_per_round: Optional[float] = None,
        compression_algorithm: Optional[str] = "zlib",
        data_seed: int = 0,
        client_index: int = 0,
        num_clients: int = 100,
        partition_strategy: str = "non_iid",
        poll_interval_s: float = 2.0,
        max_rounds: Optional[int] = None,
        samples_override: Optional[int] = None,
        n_train_synth: int = 20_000,
        n_test_synth: int = 4_000,
        tls_root_cert_path: Optional[str] = None,
        tls_cert_path: Optional[str] = None,
        tls_key_path: Optional[str] = None,
        secure_aggregation: bool = False,
        secagg_phase_timeout_s: float = 60.0,
        distributed_dp: bool = False,
        ddp_bits: int = 14,
        adaptive_clipping: bool = False,
        clip_count_stddev: float = 0.5,
        dp_noise_secret: Optional[bytes] = None,
        dp_secret_path: Optional[str] = None,
        device=None,
    ):
        from fl_tpu_torch.services.grpc_client import (
            ClientConnectionManager,
            FederatedLearningClient,
        )

        self.client_id = client_id
        self.dataset = dataset
        self.model_name = model_name
        self.device = resolve_device("FederatedTrainer", device, None)
        self.capabilities = capabilities or ClientCapabilities(
            compute_power=ComputePowerLevel.MEDIUM,
            network_bandwidth=25,
            available_samples=samples_override or 1000,
            supported_models=["simple_cnn", "cifar10_cnn"],
        )
        self.privacy = privacy
        # per-round (ε, δ) spend; default = the whole budget per round,
        # the reference's own semantics (federated_trainer.py:428: each
        # round calls add_noise with the full ε, exhausting the budget
        # after one round). Set a fraction for multi-round DP runs.
        self.eps_r = (epsilon_per_round if epsilon_per_round is not None
                      else (privacy.epsilon if privacy else 0.0))
        self.del_r = (delta_per_round if delta_per_round is not None
                      else (privacy.delta if privacy else 0.0))
        self.compression = (create_compression_service(compression_algorithm)
                            if compression_algorithm else None)
        self.client_index = client_index
        self.num_clients = num_clients
        self.partition_strategy = partition_strategy
        self.data_seed = data_seed
        self.poll_interval_s = poll_interval_s
        self.max_rounds = max_rounds

        self.client = FederatedLearningClient(
            host=coordinator_host, port=coordinator_port, client_id=client_id,
            tls_root_cert_path=tls_root_cert_path,
            tls_cert_path=tls_cert_path, tls_key_path=tls_key_path,
        )
        # secure aggregation over the wire (services/secagg_wire.py,
        # Bonawitz CCS'17): an X25519 keypair a trainer; the pubkey rides
        # the registration metadata; uploads are sample-scaled,
        # double-masked mod 2^32, with Shamir shares ferried through the
        # coordinator for dropout recovery
        self.secure_aggregation = secure_aggregation
        self.secagg_phase_timeout_s = float(secagg_phase_timeout_s)
        self._secagg_sk = self._secagg_pk = None
        if secure_aggregation:
            from fl_tpu_torch.services.secagg_crypto import generate_keypair

            self._secagg_sk, self._secagg_pk = generate_keypair()
        # distributed DP over the wire (fl.distributed_dp): the client
        # clips its DELTA, adds its own Skellam noise share, and ships
        # integers through the masked pipeline; the coordinator (which
        # must run with the same distributed_dp=True and ddp_bits) decodes
        # only the modular sum. The plan's expected cohort is the frozen
        # roster size, known identically to every party; z and the clip
        # norm come from the shared PrivacyConfig.
        self.distributed_dp = bool(distributed_dp)
        self.ddp_bits = int(ddp_bits)
        if self.distributed_dp:
            if not secure_aggregation:
                raise ValueError(
                    "distributed_dp releases only the integer SUM; it "
                    "requires secure_aggregation=True (the masked wire)")
            if privacy is None:
                raise ValueError("distributed_dp needs a PrivacyConfig "
                                 "(clip norm + noise multiplier)")
        # wire adaptive clipping (Andrew et al. 2021 over the deployment
        # path): the coordinator steers the clip norm C through the
        # per-round RoundConfig.privacy_config broadcast; this client clips
        # to the broadcast C, noises its delta at the INFLATED z_Δ (so that
        # the joint release with the indicator is one Gaussian mechanism at
        # the plain per-round (ε, δ)), locally noises its clipped-count
        # indicator b_i at σ_b, and ships b̃_i in
        # training_metrics.additional_metrics. Per-client accounting is
        # unchanged: the same (eps_r, del_r) a round as without it.
        self.adaptive_clipping = bool(adaptive_clipping)
        self.clip_count_stddev = float(clip_count_stddev)
        if self.adaptive_clipping:
            if privacy is None:
                raise ValueError("adaptive_clipping needs a PrivacyConfig")
            if self.distributed_dp:
                raise ValueError(
                    "adaptive_clipping cannot compose with distributed_dp "
                    "on the wire: the integer pipeline's quantization grid "
                    "is derived from a FIXED clip norm shared by every "
                    "party at plan time")
            if secure_aggregation:
                raise ValueError(
                    "adaptive_clipping cannot compose with "
                    "secure_aggregation on the wire: training metrics are "
                    "withheld under secagg (masked payloads must not ship "
                    "next to plaintext per-client signals), so the "
                    "indicator channel does not exist; a secagg-compatible "
                    "variant would aggregate indicators through the masked "
                    "sum itself")
            # fail at construction, not mid-round: Theorem 1 needs
            # 2σ_b > z for the joint mechanism to be realizable
            _z = (math.sqrt(2.0 * math.log(1.25 / self.del_r))
                  / self.eps_r)
            adaptive_clip_delta_multiplier(_z, self.clip_count_stddev)
        self.connection = ClientConnectionManager(self.client)

        self.state = ClientState.IDLE
        self.rounds_completed = 0
        self.training_history: list = []
        self.budget_tracker: Optional[PrivacyBudgetTracker] = (
            PrivacyBudgetTracker(privacy.epsilon, privacy.delta)
            if privacy else None
        )

        self.n_train_synth = n_train_synth
        self.n_test_synth = n_test_synth

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._model = None
        self._template = None
        self._shard = None
        self._train_fn_cache: dict = {}
        # Two root seeds with different trust requirements:
        #
        # 1. _root_seed: data shuffle / training-order streams only. A
        #    stable digest (NOT hash(): Python string hashing is randomized
        #    per process), so a restarted client replays the same shuffle
        #    for the same (client_id, round).
        # 2. _dp_root_seed: every privacy-bearing stream (DP_NOISE,
        #    DISTRIBUTED_DP).
        #    Derived by keying the digest with SECRET per-client entropy:
        #    were the noise seed computable from the public client_id,
        #    anyone knowing (client_id, client_index, round), e.g. the
        #    coordinator, could regenerate the exact Gaussian draws and
        #    subtract them from the upload, voiding the (ε, δ) guarantee.
        #    The secret comes from, in priority order: an injected
        #    test/resume secret, a client-held secret file (created 0600 on
        #    first use so resume reproduces noise only to the client
        #    itself), or fresh os.urandom (non-resumable noise, still
        #    correct DP).
        digest = hashlib.sha256(client_id.encode()).digest()
        self._root_seed = prng.root_seed_from_digest(digest)
        secret = dp_noise_secret
        if secret is None and dp_secret_path is not None:
            secret = self._load_or_create_dp_secret(dp_secret_path)
        if secret is None:
            secret = os.urandom(32)
        dp_digest = hmac.new(secret, client_id.encode(),
                             hashlib.sha256).digest()
        self._dp_root_seed = prng.root_seed_from_digest(dp_digest)

    @staticmethod
    def _load_or_create_dp_secret(path: str) -> bytes:
        p = pathlib.Path(path)
        if p.exists():
            secret = p.read_bytes()
            if len(secret) < 16:
                raise ValueError(
                    f"dp secret at {path} is {len(secret)} bytes; refusing "
                    "to derive DP noise keys from <128 bits of entropy")
            return secret
        p.parent.mkdir(parents=True, exist_ok=True)
        secret = os.urandom(32)
        fd = os.open(str(p), os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            os.write(fd, secret)
        finally:
            os.close(fd)
        return secret

    def dp_noise_seed(self, round_number: int,
                      stream: prng.Stream = prng.Stream.DP_NOISE) -> int:
        """The seed of this client's DP noise in a round: secret root →
        round → client index → ``stream`` (``DP_NOISE`` for the Gaussian
        release, ``DISTRIBUTED_DP`` for the Skellam share)."""
        return prng.stream_seed(prng.client_seed(
            prng.round_seed(self._dp_root_seed, round_number),
            self.client_index), stream)

    # -- initialization (ref: initialize, federated_trainer.py:109-207) -------
    def initialize(self) -> None:
        from fl_tpu_torch.data import load_dataset, make_federated_arrays

        self._model = get_model_for_dataset(self.dataset) \
            if self.model_name is None else None
        if self._model is None:
            from fl_tpu_torch.models import create_model

            self._model = create_model(self.model_name)
        # the structure every downloaded model is loaded into
        self._template = init_variables(self._model, seed=0,
                                        device=self.device)

        splits = load_dataset(self.dataset,
                              n_train_synth=self.n_train_synth,
                              n_test_synth=self.n_test_synth,
                              seed=self.data_seed)
        arrays = make_federated_arrays(
            splits, num_clients=self.num_clients,
            strategy=self.partition_strategy, seed=self.data_seed,
        )
        idx = self.client_index % arrays.num_clients
        dev = self.device
        self._shard = {
            "images": torch.as_tensor(arrays.images[idx:idx + 1]).to(dev),
            "labels": torch.as_tensor(
                arrays.labels[idx:idx + 1]).to(dev, torch.int64),
            "n": torch.as_tensor(arrays.num_samples[idx:idx + 1]).to(dev),
            "mean": torch.as_tensor(arrays.mean).to(dev, torch.float32),
            "std": torch.as_tensor(arrays.std).to(dev, torch.float32),
            "spc": arrays.samples_per_client,
        }
        self.capabilities.available_samples = int(arrays.num_samples[idx])
        logger.info("%s initialized: %s shard with %d samples",
                    self.client_id, self.dataset,
                    self.capabilities.available_samples)

    def _build_train_fn(self, cfg: FederatedTrainingConfig):
        # one trainer per hyperparameter tuple
        key = (cfg.local_epochs, cfg.batch_size, cfg.learning_rate,
               cfg.optimizer_type)
        fn = self._train_fn_cache.get(key)
        if fn is None:
            fn = make_local_train_fn(
                self._model, cfg,
                samples_per_client=self._shard["spc"],
                mean=self._shard["mean"], std=self._shard["std"],
            )
            self._train_fn_cache[key] = fn
        return fn

    # -- lifecycle (ref: start_training/_training_loop :209-316) -------------
    def start_training(self) -> None:
        if self._model is None:
            self.initialize()
        self._stop.clear()
        self._thread = threading.Thread(target=self._training_loop,
                                        daemon=True,
                                        name=f"fl-client-{self.client_id}")
        self._thread.start()

    def stop_training(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        try:
            self.connection.stop()
        except Exception:
            pass
        self.state = ClientState.STOPPED

    def run_forever(self) -> None:
        """Blocking entry for the CLI."""
        self.start_training()
        try:
            while self._thread is not None and self._thread.is_alive():
                self._thread.join(timeout=1.0)
        except KeyboardInterrupt:
            self.stop_training()

    # -- the FSM ---------------------------------------------------------------
    def _training_loop(self) -> None:
        """ref: _training_loop, federated_trainer.py:267-316."""
        backoff = 1.0
        try:
            self.state = ClientState.CONNECTING
            self.connection.start()
            metadata = None
            if self.secure_aggregation:
                metadata = {PUBKEY_METADATA_KEY: self._secagg_pk.hex()}
            self.client.register(self.capabilities, metadata=metadata)
            self.state = ClientState.REGISTERED
        except Exception as e:
            logger.error("%s failed to connect: %s", self.client_id, e)
            self.state = ClientState.ERROR
            return

        last_round = -1
        while not self._stop.is_set():
            if (self.max_rounds is not None
                    and self.rounds_completed >= self.max_rounds):
                break
            try:
                self.state = ClientState.WAITING_FOR_ROUND
                status = self.client.get_training_status()
                if status.current_round == last_round:
                    self._stop.wait(self.poll_interval_s)
                    continue
                self._run_one_round(status.current_round)
                last_round = status.current_round
                backoff = 1.0
            except Exception as e:
                logger.error("%s round failed: %s", self.client_id, e)
                self.state = ClientState.ERROR
                # reconnect with backoff (ref: _handle_error :528-545)
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 30.0)
        self.state = ClientState.STOPPED

    def _run_one_round(self, round_number: int) -> None:
        """One FSM cycle (ref: §3.2 call stack). The history entry keeps
        the host-clock seconds of the round's stages."""
        t0 = time.time()
        # 1. join + adaptive config (ref: _wait_for_round :318-365)
        round_cfg = self.client.join_training_round(round_number)
        cfg = create_adaptive_config({
            "compute_power": self.capabilities.compute_power.value,
            "network_bandwidth": self.capabilities.network_bandwidth,
            "available_samples": self.capabilities.available_samples,
        })
        # round config overrides adaptive choices (ref :336-338)
        cfg = FederatedTrainingConfig(
            local_epochs=round_cfg.local_epochs or cfg.local_epochs,
            batch_size=round_cfg.batch_size or cfg.batch_size,
            learning_rate=round_cfg.learning_rate or cfg.learning_rate,
            optimizer_type=round_cfg.optimizer_type or cfg.optimizer_type,
        )

        # 2. download global model (ref: _download_global_model :367-388)
        self.state = ClientState.DOWNLOADING_MODEL
        gm = self.client.get_global_model(round_number)
        variables = set_model_weights(self._template, gm.model_weights)

        # 3. local training (ref: _perform_local_training :390-426)
        self.state = ClientState.TRAINING
        t_train = time.time()
        train_fn = self._build_train_fn(cfg)
        cseed = prng.client_seed(prng.round_seed(self._root_seed,
                                                 round_number),
                                 self.client_index)
        new_vars, metrics = train_variables(
            train_fn, tree_map(lambda v: v[None], variables),
            self._shard["images"], self._shard["labels"], self._shard["n"],
            cseed)
        new_vars = tree_map(lambda v: v[0], new_vars)
        loss = float(metrics["loss"][0])
        acc = float(metrics["accuracy"][0])
        train_time = time.time() - t0
        stages = {"train_s": time.time() - t_train}

        # 4. differential privacy on the delta
        #    (ref: _apply_differential_privacy :428-469)
        t_dp = time.time()
        eps_used = 0.0
        upload_weights = get_model_weights(new_vars)
        ddp_delta = None
        adaptive_report: Dict[str, float] = {}
        if self.distributed_dp:
            # the DP release is the integer pipeline inside the secagg
            # block below (clip -> grid -> Skellam share -> mask); the
            # per-client Gaussian noising does not apply
            old_w = get_model_weights(variables)
            ddp_delta = {k: to_numpy(upload_weights[k] - old_w[k])
                         for k in upload_weights}
            upload_weights = {k: to_numpy(v)
                              for k, v in upload_weights.items()}
        elif self.privacy is not None:
            self.state = ClientState.APPLYING_PRIVACY
            if self.budget_tracker.is_budget_exhausted(self.eps_r,
                                                       self.del_r):
                raise RuntimeError("privacy budget exhausted")
            old_w = get_model_weights(variables)
            delta = {k: upload_weights[k] - old_w[k] for k in upload_weights}
            # noise seeds descend from the SECRET dp root, never from the
            # training root (which is derivable from the public client_id)
            nseed = self.dp_noise_seed(round_number)
            if self.adaptive_clipping:
                # clip to the coordinator-broadcast C for THIS round (the
                # geometric quantile tracker on the server moves it between
                # rounds); fall back to the local config if the broadcast
                # omits a privacy config
                clip_c = float(
                    round_cfg.privacy_config.max_grad_norm
                    if round_cfg.privacy_config is not None
                    else self.privacy.max_grad_norm)
                z = (math.sqrt(2.0 * math.log(1.25 / self.del_r))
                     / self.eps_r)
                z_delta = adaptive_clip_delta_multiplier(
                    z, self.clip_count_stddev)
                noisy, pre_norm = clip_and_noise_tree_at_sigma(
                    delta, prng.fold(nseed, 0), clip_c, z_delta * clip_c)
                # locally noised clipped-count indicator: the (Δ/C, b−½)
                # pair noised at (z_Δ, σ_b) is one Gaussian mechanism at z
                # (Andrew et al. 2021, Thm 1), so shipping b̃ in plaintext
                # metrics releases nothing beyond the accounted (ε, δ)
                indicator = float(float(pre_norm) <= clip_c)
                indicator += self.clip_count_stddev * float(torch.randn(
                    (), generator=prng.generator(prng.fold(nseed, 1),
                                                 "cpu")))
                adaptive_report = {
                    "adaptive_clip_indicator": indicator,
                    "adaptive_clip_norm": clip_c,
                }
            else:
                noisy, _, _ = clip_and_noise_tree(
                    delta, nseed, self.eps_r, self.del_r,
                    self.privacy.max_grad_norm,
                )
            upload_weights = {k: to_numpy(old_w[k] + noisy[k])
                              for k in noisy}
            # budget is consumed immediately BEFORE transmission (below):
            # a failure that provably happens pre-transmit releases nothing
            # and burns no epsilon, but once submit_model_update is CALLED
            # the noised weights are on the wire, so even a rejected
            # submission (stale round, etc.) is a genuine release and must
            # be charged.
            eps_used = self.eps_r
        else:
            upload_weights = {k: to_numpy(v)
                              for k, v in upload_weights.items()}
        stages["privacy_s"] = time.time() - t_dp

        # 5. compression (actually applied, unlike ref :484)
        t_c = time.time()
        compression_ratio = 1.0
        if self.compression is not None:
            _, meta = self.compression.compress_weights(upload_weights)
            compression_ratio = min(1.0, meta["compression_ratio"])
        stages["compress_s"] = time.time() - t_c

        # 6. upload (ref: _upload_model_update :471-526)
        self.state = ClientState.UPLOADING_UPDATE
        n_samples = int(self._shard["n"][0])
        secagg_session = None
        if self.secure_aggregation:
            secagg_session, upload_weights, n_samples, eps_used = \
                self._secagg_mask(round_number, upload_weights, ddp_delta,
                                  n_samples, eps_used, stages)
        # under secure aggregation, per-client loss/accuracy are withheld
        # (masked weights would otherwise ship next to a plaintext training
        # signal: a membership/property-inference channel)
        wire_loss = 0.0 if self.secure_aggregation else loss
        wire_metrics = None if self.secure_aggregation else TrainingMetrics(
            loss=loss, accuracy=acc,
            epochs_completed=cfg.local_epochs,
            training_time=train_time,
            samples_processed=n_samples * cfg.local_epochs,
            additional_metrics=adaptive_report,
        )
        update = ModelUpdate(
            client_id=self.client_id,
            round_number=round_number,
            model_weights=upload_weights,
            num_samples=n_samples,
            training_loss=wire_loss,
            privacy_budget_used=min(1.0, eps_used),
            compression_ratio=compression_ratio,
            training_metrics=wire_metrics,
        )
        if self.budget_tracker is not None and eps_used > 0.0:
            # charge the ledger BEFORE the payload leaves the process: a
            # transmitted-but-rejected upload is still a release. Under
            # distributed DP the charge is the Skellam-RDP epsilon at the
            # minimum survivor count, not the per-round Gaussian eps_r.
            self.budget_tracker.consume_budget(
                eps_used if self.distributed_dp else self.eps_r,
                self.del_r or (self.privacy.delta if self.privacy else 0.0),
                f"round_{round_number}")
        t_up = time.time()
        resp = self.client.submit_model_update(update)
        stages["upload_s"] = time.time() - t_up
        if not resp["success"]:
            raise RuntimeError(f"update rejected: {resp['message']}")

        if secagg_session is not None:
            # phase 3: wait for the survivor set, then reveal the
            # reconstruction shares (self-mask seeds for survivors, DH key
            # shares for dropped peers). The session enforces the
            # one-shot/consistency rules.
            t_rv = time.time()
            survivors, dropped, nonce = self._secagg_wait(
                lambda: self.client.get_secagg_reveal(round_number),
                "survivor-set freeze")
            items = secagg_session.reveal(survivors, dropped)
            if not self.client.submit_secagg_reveal(round_number, nonce,
                                                    items):
                # non-fatal: the reveal threshold was already met and the
                # round advanced without this straggler's shares
                logger.info("%s reveal arrived after round %d completed",
                            self.client_id, round_number)
            stages["secagg_reveal_s"] = time.time() - t_rv

        self.state = ClientState.ROUND_COMPLETE
        self.rounds_completed += 1
        self.training_history.append({
            "round": round_number, "loss": loss, "accuracy": acc,
            "time_s": time.time() - t0, "epsilon_used": eps_used,
            **stages,
        })
        logger.info("%s completed round %d: loss=%.4f acc=%.3f (%.1fs)",
                    self.client_id, round_number, loss, acc, time.time() - t0)

    def _secagg_mask(self, round_number: int, upload_weights, ddp_delta,
                     n_samples: int, eps_used: float, stages: dict):
        """The masked uplink (ref: federated_trainer.py:515-590): roster ->
        encrypted Shamir share exchange -> double-masked mod-2^32 payload,
        the distributed-DP integer payload in its place where configured.
        The coordinator only ever sees the masked payload; a delta-DP
        release was already made on the device, so masking is
        post-processing. Every wait happens BEFORE transmission, so raising
        out of one burns no epsilon. Returns (session, payload, the
        samples to report, epsilon to charge)."""
        t_ro = time.time()
        info = self._secagg_wait(
            lambda: self.client.get_secagg_roster(round_number),
            "roster freeze")
        if self.client_id not in {cid for cid, _ in info["peers"]}:
            raise RuntimeError(
                f"{self.client_id} not in the round {round_number} "
                "secagg roster; skipping upload")
        stages["secagg_roster_s"] = time.time() - t_ro
        t_sh = time.time()
        session = SecAggClientSession(
            self.client_id, self._secagg_sk, round_number,
            info["peers"], info["nonce"], info["threshold"],
            info["frac_bits"],
        )
        self.client.submit_secagg_shares(
            round_number, info["nonce"], session.make_share_uploads())
        bundles = self._secagg_wait(
            lambda: self.client.get_secagg_shares(round_number),
            "peer share exchange")
        session.receive_shares(bundles)
        stages["secagg_share_s"] = time.time() - t_sh
        t_mk = time.time()
        if self.distributed_dp:
            # the integer payload: a plan derived from values every party
            # shares (PrivacyConfig + frozen roster size + model dim), so
            # client and coordinator decode identically
            dim = int(sum(v.size for v in ddp_delta.values()))
            plan = DistributedDPPlan(
                clip_norm=float(self.privacy.max_grad_norm),
                bits=self.ddp_bits, dim=dim,
                expected_clients=len(info["peers"]),
                noise_multiplier=float(self.privacy.noise_multiplier))
            rng = np.random.default_rng(self.dp_noise_seed(
                round_number, prng.Stream.DISTRIBUTED_DP))
            payload = host_client_integer_payload(ddp_delta, plan, rng)
            masked = session.mask_integer_payload(payload)
            # conservative ledger charge: the summed noise could be as
            # small as the minimum survivor set the protocol accepts
            delta_r = self.del_r or self.privacy.delta
            eps_used = distributed_epsilon(plan, 1, delta_r,
                                           realized=info["threshold"])
            if self.budget_tracker.is_budget_exhausted(eps_used, delta_r):
                raise RuntimeError("privacy budget exhausted")
            # distributed DP decodes an UNWEIGHTED fixed-denominator mean;
            # a true count would also leak
            n_samples = 1
        else:
            masked = session.mask_payload(upload_weights, n_samples)
        stages["secagg_mask_s"] = time.time() - t_mk
        return session, masked, n_samples, eps_used

    def _secagg_wait(self, fn, what: str):
        """Poll ``fn() -> (ready, payload...)`` until ready within the
        phase timeout. Returns the payload (unwrapped when single)."""
        deadline = time.time() + self.secagg_phase_timeout_s
        while True:
            out = fn()
            if out[0]:
                rest = out[1:]
                return rest[0] if len(rest) == 1 else rest
            if time.time() > deadline:
                raise RuntimeError(
                    f"secagg {what} not ready within "
                    f"{self.secagg_phase_timeout_s:.0f}s")
            if self._stop.wait(0.5):
                raise RuntimeError(f"stopped while waiting for secagg "
                                   f"{what}")

    # -- introspection -----------------------------------------------------------
    def get_status(self) -> Dict[str, Any]:
        return {
            "client_id": self.client_id,
            "state": self.state.value,
            "rounds_completed": self.rounds_completed,
            "history": self.training_history[-10:],
            "budget": (self.budget_tracker.get_budget_status()
                       if self.budget_tracker else None),
        }


def create_federated_trainer(client_id: str, **kwargs: Any
                             ) -> FederatedTrainer:
    """Factory (ref: create_federated_trainer,
    federated_trainer.py:591-644)."""
    return FederatedTrainer(client_id=client_id, **kwargs)
