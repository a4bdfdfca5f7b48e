"""The 2-rank runs of the port's sharded round engine and of the clustered,
Ditto, async, hierarchical, decentralized, FedDF and HPO engines that the
mesh tests read (``test_torch_mesh.py``, ``test_torch_mesh_features.py``,
``test_torch_engines_mesh.py``, ``test_torch_topologies_mesh.py``,
``test_torch_validation_mesh.py``).

Spawning ranks costs seconds, so each test file's 2-rank cases run in ONE
launch a test session: :func:`mesh_results` runs :func:`rank_job` on two
gloo ranks on the CPU under a file lock in the session's shared temporary
directory (pytest-xdist's recipe), writes the ranks' results there, and
every test of that file reads them. The launch's inputs are built here in the
test process, where the reference package may be imported; the ranks
import this module for :func:`rank_job` and so import torch and the port
only.
"""

from __future__ import annotations

import copy
import os
import pickle

import numpy as np
import torch

from fl_tpu_torch.core.mesh import spawn
from fl_tpu_torch.core.types import PrivacyConfig
from fl_tpu_torch.data import load_dataset, make_federated_arrays
from fl_tpu_torch.fl.local_training import FederatedTrainingConfig
from fl_tpu_torch.models import create_model
from fl_tpu_torch.orchestration import FederatedRoundEngine, RoundEngineConfig

WORLD = 2
N_CLIENTS, SPC = 8, 16          # the feature matrix's shapes
JAX_CLIENTS = 16                # the JAX comparisons' and the inventory's
LR = 1e-3
# families whose server state carries into the next round run two rounds
# (the uplink's error feedback is per client; its int8 quantizer turns a
# last-bit difference of the float sums into a whole step, one element in
# 18,432 of conv2's kernel after a second round, so it runs one, as every
# family does in the reference's matrix)
TWO_ROUNDS = ("server_optimizer", "scaffold", "feddyn")


def arrays(num_clients=N_CLIENTS, spc=SPC, seed=0):
    splits = load_dataset("mnist", n_train_synth=num_clients * spc,
                          n_test_synth=64)
    return make_federated_arrays(splits, num_clients=num_clients,
                                 strategy="iid", samples_per_client=spc,
                                 seed=seed)


# ---------------------------------------------------------------------------
# the feature matrix (built in the test process from the reference's
# fragments, as tests/test_feature_matrix.py builds its configs)
# ---------------------------------------------------------------------------

def feature_config(name: str) -> RoundEngineConfig:
    """The port's config of one reference feature family, with its needs:
    the reference's ``_build_config`` (fragments merged, ε 1000, δ 1e-5,
    C 1, z 6, one epoch at batch 8, lr 0.05, Adam unless the fragment says
    otherwise, seed 3)."""
    from fl_tpu.orchestration.features import FEATURES

    names = [name] + [n for n in FEATURES[name].needs if n != name]
    kwargs: dict = {}
    for n in names:
        for k, v in copy.deepcopy(dict(FEATURES[n].fragment)).items():
            if k == "training":
                kwargs.setdefault("training", {}).update(v)
            else:
                kwargs[k] = v
    if kwargs.pop("privacy", None) or any(
            FEATURES[n].axis == "dp_mode" for n in names):
        # at ε 1000 the PLD step budget's search would run to 2^24 steps
        # on the auto grid: the PLD case certifies ε 4 on a 1e-3 grid
        # (about 120 steps)
        pld = kwargs.get("accountant") == "pld"
        kwargs["privacy"] = PrivacyConfig(epsilon=4.0 if pld else 1000.0,
                                          delta=1e-5, max_grad_norm=1.0,
                                          noise_multiplier=6.0)
        if pld:
            kwargs["pld_dt"] = 1e-3
    tkw = kwargs.pop("training", {})
    tkw.setdefault("optimizer_type", "adam")
    kwargs["training"] = FederatedTrainingConfig(
        local_epochs=1, batch_size=8, learning_rate=0.05, **tkw)
    return RoundEngineConfig(max_clients=N_CLIENTS, seed=3, **kwargs)


def feature_rounds(name: str, cfg: RoundEngineConfig, mesh=None) -> dict:
    """One round of a feature family (two where its state carries), every
    client participating: on ``mesh`` if given, else in this process on
    the CPU. Returns the losses, the weights and the per-client losses."""
    engine = FederatedRoundEngine(
        create_model("simple_cnn"), arrays(), cfg,
        device=None if mesh is not None else "cpu", mesh=mesh)
    mask = np.ones(N_CLIENTS, np.float32)
    rounds = 2 if name in TWO_ROUNDS else 1
    results = [engine.run_round(mask=mask, evaluate=False)
               for _ in range(rounds)]
    return {"losses": [r.train_loss for r in results],
            "weights": {k: v.cpu().numpy()
                        for k, v in engine.get_model_weights().items()},
            "client_losses": np.asarray(engine.last_client_losses)}


# ---------------------------------------------------------------------------
# the comparisons with the JAX engine, and the collective inventory
# ---------------------------------------------------------------------------

def jax_comparable_config(dp: bool) -> RoundEngineConfig:
    """FedAvg or delta DP with the draws taken out of the comparison:
    one full-batch step an epoch (spc = batch = 16), ε 1e9."""
    priv = (dict(dp_mode="delta",
                 privacy=PrivacyConfig(epsilon=1e9, delta=1e-5,
                                       max_grad_norm=1.0),
                 epsilon_per_round=1e8, delta_per_round=1e-6)
            if dp else {})
    return RoundEngineConfig(
        training=FederatedTrainingConfig(local_epochs=2, batch_size=16,
                                         learning_rate=LR),
        max_clients=JAX_CLIENTS, seed=5, **priv)


def jax_comparable_round(cfg, init_weights, mesh=None) -> dict:
    """One round from the given initial weights (the JAX engine's)."""
    engine = FederatedRoundEngine(
        create_model("simple_cnn", dropout_rate=0.0), arrays(JAX_CLIENTS),
        cfg,
        device=None if mesh is not None else "cpu", mesh=mesh)
    engine.set_model_weights(init_weights)
    r = engine.run_round(mask=np.ones(JAX_CLIENTS, np.float32),
                         evaluate=False)
    return {"loss": r.train_loss, "epsilon": r.epsilon_spent,
            "weights": {k: v.cpu().numpy()
                        for k, v in engine.get_model_weights().items()}}


def inventory_config(**overrides) -> RoundEngineConfig:
    """The bench's configuration at 16 clients: delta DP, Adam with bf16
    moments (the reference's tests/test_collective_audit.py)."""
    kw = dict(dp_mode="delta",
              privacy=PrivacyConfig(epsilon=1.0, delta=1e-5,
                                    max_grad_norm=1.0),
              epsilon_per_round=0.1, delta_per_round=1e-6)
    kw.update(overrides)
    return RoundEngineConfig(
        training=FederatedTrainingConfig(local_epochs=1, batch_size=8,
                                         optimizer_state_dtype="bfloat16"),
        max_clients=JAX_CLIENTS, seed=0, **kw)


def inventory(mesh, cfg, fused) -> list:
    engine = FederatedRoundEngine(
        create_model("simple_cnn", fused_conv_block=fused),
        arrays(JAX_CLIENTS), cfg, mesh=mesh)
    engine.run_round(mask=np.ones(JAX_CLIENTS, np.float32), evaluate=False)
    return [tuple(c) for c in engine.round_collectives]


INVENTORY_CASES = {
    "bench": (dict(), "residual"),
    "median": (dict(dp_mode="none", privacy=None, aggregation="median"),
               False),
    "secure": (dict(dp_mode="none", privacy=None, secure_aggregation=True),
               False),
}


def run_audit(mesh=None) -> dict:
    """A small client_dp audit: 6 clients and 2 update canaries, 2
    rounds."""
    from fl_tpu_torch.validation.audit import run_client_membership_audit

    cfg = RoundEngineConfig(
        training=FederatedTrainingConfig(local_epochs=1, batch_size=8),
        dp_mode="client_dp",
        privacy=PrivacyConfig(epsilon=1000.0, delta=1e-5,
                              max_grad_norm=1.0, noise_multiplier=1.0),
        participation_rate=1.0, max_clients=N_CLIENTS, seed=2)
    return run_client_membership_audit(
        create_model("simple_cnn"), arrays(6), cfg, mesh=mesh,
        device="cpu", num_canaries=2, num_rounds=2, canary_samples=4,
        seed=1)


def entry_point_config() -> RoundEngineConfig:
    """Delta DP (ε 1e9) at 3/4 participation: the masks are the engine's
    own draws."""
    return RoundEngineConfig(
        training=FederatedTrainingConfig(local_epochs=1, batch_size=8),
        dp_mode="delta",
        privacy=PrivacyConfig(epsilon=1e9, delta=1e-5, max_grad_norm=1.0),
        epsilon_per_round=1e8, delta_per_round=1e-6,
        participation_rate=0.75, max_clients=N_CLIENTS, seed=4)


def eval_set():
    splits = load_dataset("mnist", n_train_synth=N_CLIENTS * SPC,
                          n_test_synth=64)
    return splits.normalized(splits.test_images), splits.test_labels


def entry_point_engine(mesh=None):
    x, y = eval_set()
    return FederatedRoundEngine(
        create_model("simple_cnn"), arrays(), entry_point_config(),
        device=None if mesh is not None else "cpu", mesh=mesh,
        test_images=x, test_labels=y)


def entry_points(mesh) -> dict:
    """Two rounds through each of ``run_round``, ``run_rounds_pipelined``
    and ``run_rounds_fused`` on fresh engines, and ``evaluate`` of a fresh
    engine's initial model."""
    out = {"evaluate": entry_point_engine(mesh).evaluate()}
    for how in ("run_round", "pipelined", "fused"):
        engine = entry_point_engine(mesh)
        if how == "run_round":
            results = [engine.run_round(evaluate=False) for _ in range(2)]
        elif how == "pipelined":
            results = engine.run_rounds_pipelined(2)
        else:
            results = engine.run_rounds_fused(2, evaluate=False)
        out[how] = {
            "losses": [r.train_loss for r in results],
            "participants": [r.participating_clients for r in results],
            "weights": {k: v.numpy()
                        for k, v in engine.get_model_weights().items()}}
    return out


def collectives(mesh) -> dict:
    """The communicator's and the mesh helpers' own results on this rank."""
    from fl_tpu_torch.core.mesh import replicate_tree
    from fl_tpu_torch.parallel import (
        Communicator, fedavg_psum_shard_map, make_sharded_fedavg)

    r = mesh.rank
    comm = Communicator(mesh)
    summed = comm.psum_tree({"a": torch.full((3,), float(r + 1)),
                             "b": {"c": torch.arange(4.0) * (r + 1)}})
    tree_calls = list(comm.calls)
    comm.begin_round()
    gathered = comm.gather_clients({"x": torch.full((2, 3), float(r))})
    ints = comm.psum(torch.tensor([2 ** 40 + r, -7], dtype=torch.int64))
    rng = np.random.default_rng(r)
    block = {"w": torch.from_numpy(rng.normal(size=(3, 5)).astype(
        np.float32))}
    counts = torch.tensor([3.0, 0.0, 7.0]) * (r + 1)
    mask = torch.tensor([1.0, 1.0, float(r)])
    return {
        "mesh": (mesh.rank, mesh.world_size, mesh.backend,
                 str(mesh.device)),
        "psum_tree": {"a": summed["a"].numpy(),
                      "c": summed["b"]["c"].numpy(), "calls": tree_calls},
        "gather": {"x": gathered["x"].numpy(), "calls": list(comm.calls)},
        "int64": ints.numpy(),
        "replicated": replicate_tree(
            {"w": torch.full((2,), float(r + 5))}, mesh)["w"].numpy(),
        "sharded_fedavg": (
            make_sharded_fedavg(mesh)(block, counts, mask)["w"].numpy(),
            fedavg_psum_shard_map(mesh, block, counts, mask)["w"].numpy()),
    }


# ---------------------------------------------------------------------------
# the clustered, Ditto and async engines, evaluate_federated and the
# checkpoints under a mesh (test_torch_engines_mesh.py)
# ---------------------------------------------------------------------------

SGD = dict(local_epochs=1, batch_size=8, learning_rate=0.05,
           optimizer_type="sgd", momentum=0.0)
ALL = np.ones(N_CLIENTS, np.float32)


def _device(mesh):
    return None if mesh is not None else "cpu"


def _host(tree) -> dict:
    """A tree's leaves as flat numpy arrays (every rank's rows gathered
    beforehand where they are per client)."""
    from fl_tpu_torch.core.pytree import flatten_dict

    return {k: v.detach().cpu().numpy() for k, v in
            flatten_dict(tree).items()}


def permuted_arrays():
    """:func:`arrays` with the second half's labels permuted (y + 5 mod
    10): two populations for IFCA."""
    fa = arrays()
    fa.labels[N_CLIENTS // 2:] = (fa.labels[N_CLIENTS // 2:] + 5) % 10
    return fa


def ifca_engine(mesh=None):
    from fl_tpu_torch.fl import ClusteredConfig, ClusteredFederatedEngine

    return ClusteredFederatedEngine(
        create_model("simple_cnn"), permuted_arrays(),
        ClusteredConfig(training=FederatedTrainingConfig(**dict(
            SGD, local_epochs=2)), num_clusters=2, seed=0,
            warmstart_clients=(0, N_CLIENTS - 1)),
        mesh=mesh, device=_device(mesh))


def ifca_run(mesh=None, directory=None) -> dict:
    """Two IFCA rounds (dropout live: the streams are keyed by global
    client id); with ``directory`` the engine's checkpoint is saved
    there."""
    from fl_tpu_torch.orchestration.checkpoint import (
        save_clustered_checkpoint)

    eng = ifca_engine(mesh)
    results = eng.run(2)
    out = {"sizes": [r.cluster_sizes for r in results],
           "metrics": [(r.train_loss, r.train_accuracy, r.assignment_loss)
                       for r in results],
           "assignments": eng.assignments.tolist(),
           "weights": _host(eng.cluster_variables),
           "collectives": [tuple(c) for c in eng.round_collectives]}
    if directory is not None:
        save_clustered_checkpoint(eng, directory)
    return out


def ditto_engine(mesh=None):
    return FederatedRoundEngine(
        create_model("simple_cnn"), arrays(),
        RoundEngineConfig(training=FederatedTrainingConfig(**SGD),
                          max_clients=N_CLIENTS, seed=3),
        device=_device(mesh), mesh=mesh)


def ditto_run(mesh=None, directory=None) -> dict:
    """Two (engine round, Ditto step) pairs, then ``evaluate_personal``
    and the engine's ``evaluate_federated``; with ``directory`` the
    personalizer's checkpoint is saved there."""
    from fl_tpu_torch.fl import DittoPersonalizer
    from fl_tpu_torch.orchestration.checkpoint import save_ditto_checkpoint

    eng = ditto_engine(mesh)
    ditto = DittoPersonalizer(eng, lam=0.2)
    steps = []
    for _ in range(2):
        eng.run_round(mask=ALL, evaluate=False)
        steps.append(ditto.step())
    personal = ditto.evaluate_personal()
    fed = eng.evaluate_federated()
    out = {"steps": steps,
           "personal": {k: v for k, v in personal.items()
                        if k != "per_client"},
           "personal_per_client": personal["per_client"],
           "federated": {k: v for k, v in fed.items() if k != "per_client"},
           "federated_per_client": fed["per_client"],
           "models": _host(eng._axis.gather(ditto.personal_variables))}
    if directory is not None:
        save_ditto_checkpoint(ditto, directory)
    return out


def fedbuff_engine(mesh=None):
    from fl_tpu_torch.fl import AsyncConfig, AsyncFederatedEngine

    return AsyncFederatedEngine(
        create_model("simple_cnn"), arrays(),
        AsyncConfig(training=FederatedTrainingConfig(**SGD), buffer_size=4,
                    max_staleness=2, seed=1),
        mesh=mesh, device=_device(mesh))


def fedbuff_run(mesh=None, directory=None) -> dict:
    """Four FedBuff server steps (lognormal durations, a 3-version ring:
    the buffer mixes attempts and ids, so each rank's rows take the
    trainer's per-row streams); with ``directory`` the engine's checkpoint
    is saved there."""
    from fl_tpu_torch.orchestration.checkpoint import save_async_checkpoint

    eng = fedbuff_engine(mesh)
    results = eng.run(4)
    out = {"timeline": [(r.client_ids, r.staleness, r.sim_time,
                         r.cancelled_attempts) for r in results],
           "metrics": [(r.train_loss, r.train_accuracy) for r in results],
           "weights": _host(eng.global_variables),
           "ring": _host(eng.ring),
           "collectives": [tuple(c) for c in eng.round_collectives]}
    if directory is not None:
        save_async_checkpoint(eng, directory)
    return out


def checkpoint_engine(mesh=None):
    """SCAFFOLD with the int8 uplink: per-client c_i and error feedback
    carried across rounds."""
    return FederatedRoundEngine(
        create_model("simple_cnn"), arrays(),
        RoundEngineConfig(training=FederatedTrainingConfig(**SGD),
                          scaffold=True, uplink_compression="int8",
                          max_clients=N_CLIENTS, seed=6),
        device=_device(mesh), mesh=mesh)


def engine_state(eng) -> dict:
    """The round engine's model and carried state, every client's rows."""
    return {"weights": _host(eng.global_variables),
            "c": eng.scaffold_c.cpu().numpy(),
            "ci": eng._axis.gather(eng.scaffold_ci).cpu().numpy(),
            "ef": eng._axis.gather(eng.uplink_error).cpu().numpy()}


def checkpoint_run(mesh, directory) -> dict:
    """One round, a checkpoint, the uninterrupted next round; then a fresh
    engine restored from the checkpoint and its next round."""
    from fl_tpu_torch.orchestration.checkpoint import (
        restore_engine_checkpoint, save_engine_checkpoint)

    eng = checkpoint_engine(mesh)
    eng.run_round(mask=ALL, evaluate=False)
    saved = engine_state(eng)
    save_engine_checkpoint(eng, directory)
    eng.run_round(mask=ALL, evaluate=False)
    resumed = checkpoint_engine(mesh)
    step = restore_engine_checkpoint(resumed, directory)
    restored = engine_state(resumed)
    resumed.run_round(mask=ALL, evaluate=False)
    return {"step": step, "saved": saved, "restored": restored,
            "uninterrupted": engine_state(eng),
            "resumed": engine_state(resumed)}


def engines_job(mesh, directory: str) -> dict:
    return {
        "ifca": ifca_run(mesh, os.path.join(directory, "ifca")),
        "ditto": ditto_run(mesh, os.path.join(directory, "ditto")),
        "fedbuff": fedbuff_run(mesh, os.path.join(directory, "fedbuff")),
        "checkpoint": checkpoint_run(mesh, os.path.join(directory,
                                                        "engine")),
    }


# ---------------------------------------------------------------------------
# the hierarchical, decentralized, FedDF and HPO engines under a mesh
# (test_torch_topologies_mesh.py)
# ---------------------------------------------------------------------------

HIER_EDGES = 3          # edge 1 holds clients 3-5: it spans both ranks
DISTILL_STEPS, DISTILL_BATCH = 3, 8
HPO_LRS = (0.05, 0.02, 0.1)


def hierarchical_run(mesh=None) -> dict:
    """Two HierFAVG rounds at τ = 2 (dropout live)."""
    from fl_tpu_torch.fl import (HierarchicalConfig,
                                 HierarchicalFederatedEngine)

    eng = HierarchicalFederatedEngine(
        create_model("simple_cnn"), permuted_arrays(),
        HierarchicalConfig(training=FederatedTrainingConfig(**SGD),
                           num_edges=HIER_EDGES, global_sync_every=2,
                           seed=0),
        mesh=mesh, device=_device(mesh))
    results, edges = [], []
    for _ in range(2):
        results.append(eng.run_round())
        edges.append(_host(eng.edge_variables))
    return {"metrics": [(r.train_loss, r.train_accuracy, r.edge_divergence,
                         r.cloud_synced) for r in results],
            "edges": edges, "cloud": _host(eng.cloud_variables),
            "collectives": [tuple(c) for c in eng.round_collectives]}


def decentralized_run(mesh=None) -> dict:
    """Two ring-gossip rounds (dropout live); every client's model."""
    from fl_tpu_torch.fl import (DecentralizedConfig,
                                 DecentralizedFederatedEngine)

    eng = DecentralizedFederatedEngine(
        create_model("simple_cnn"), permuted_arrays(),
        DecentralizedConfig(training=FederatedTrainingConfig(**SGD), seed=0),
        mesh=mesh, device=_device(mesh))
    results = eng.run(2)
    collectives = [tuple(c) for c in eng.round_collectives]
    return {"metrics": [(r.train_loss, r.train_accuracy,
                         r.consensus_distance) for r in results],
            "clients": _host(eng._axis.gather(eng.client_variables)),
            "mean": _host(eng.mean_model()),
            "collectives": collectives}


def proxy_set() -> np.ndarray:
    from fl_tpu_torch.data import load_dataset

    return load_dataset("mnist", n_train_synth=2 * DISTILL_BATCH,
                        n_test_synth=1, seed=5).train_images


def feddf_run(mesh=None) -> dict:
    """Two FedDF rounds of DISTILL_STEPS SGD steps (dropout live in the
    local training). SGD, not Adam: the teacher's logit sum is reduced in
    another order over two ranks, and Adam's normalized step turns that
    last-bit difference into an lr-sized step wherever a coordinate's
    gradient is near zero."""
    from fl_tpu_torch.fl import FedDFConfig, FedDFEngine

    eng = FedDFEngine(
        create_model("simple_cnn"), permuted_arrays(), proxy_set(),
        FedDFConfig(training=FederatedTrainingConfig(**SGD),
                    distill_steps=DISTILL_STEPS, distill_batch=DISTILL_BATCH,
                    distill_lr=0.05, distill_optimizer="sgd", seed=0),
        mesh=mesh, device=_device(mesh))
    results = eng.run(2)
    return {"metrics": [(r.train_loss, r.train_accuracy, r.distill_kl_before,
                         r.distill_kl_after) for r in results],
            "weights": _host(eng.global_variables),
            "collectives": [tuple(c) for c in eng.round_collectives]}


def hpo_run(mesh=None) -> dict:
    """Three trials, a rung after round 0 (η = 2), two rounds (dropout
    live)."""
    from fl_tpu_torch.fl import FederatedHPOEngine, HPOConfig

    splits = load_dataset("mnist", n_train_synth=N_CLIENTS * SPC,
                          n_test_synth=64)
    eng = FederatedHPOEngine(
        create_model("simple_cnn"), arrays(),
        HPOConfig(training=FederatedTrainingConfig(**SGD),
                  learning_rates=HPO_LRS, rung_rounds=(0,), eta=2, seed=0),
        splits.test_images, splits.test_labels, mesh=mesh,
        device=_device(mesh))
    first = eng.run_round()
    collectives = [tuple(c) for c in eng.round_collectives]
    second = eng.run_round()
    return {"rounds": [(r.val_accuracies, r.alive_trials, r.best_trial_id,
                        r.halved) for r in (first, second)],
            "alive": list(eng._alive_ids),
            "weights": _host(eng.trial_variables),
            "collectives": collectives}


def validation_run(mesh=None, directory=None) -> dict:
    """One round of the entry points' engine, then ``evaluate_personalized``
    (with the communicator's calls it made) and ``profile_round`` (its
    trace under ``directory``)."""
    engine = entry_point_engine(mesh)
    engine.run_round(evaluate=False)
    before = len(engine._axis.calls)
    personalized = engine.evaluate_personalized()
    calls = engine._axis.calls[before:]
    result = engine.profile_round(directory)
    return {"personalized": personalized,
            "personalize_calls": [tuple(c) for c in calls],
            "profile_loss": result.train_loss,
            "trace": engine.last_trace_path,
            "weights": {k: v.cpu().numpy()
                        for k, v in engine.get_model_weights().items()}}


def topologies_job(mesh) -> dict:
    return {"hierarchical": hierarchical_run(mesh),
            "decentralized": decentralized_run(mesh),
            "feddf": feddf_run(mesh), "hpo": hpo_run(mesh)}


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------

def rank_job(mesh, spec: dict) -> dict:
    """The 2-rank cases of one test file on one rank: each result is the
    rank's own (the tests hold the ranks equal where the values are
    replicated)."""
    from fl_tpu_torch.parallel import fedavg_psum_shard_map

    if "features" in spec:
        return {"features": {name: feature_rounds(name, cfg, mesh)
                             for name, cfg in spec["features"].items()}}
    if "engines" in spec:
        return engines_job(mesh, spec["engines"])
    if "topologies" in spec:
        return topologies_job(mesh)
    if "validation" in spec:
        return validation_run(mesh, spec["validation"])
    lo, hi = mesh.client_rows(spec["fedavg"]["counts"].shape[0])
    fedavg = {}
    for label, mask in (("masked", spec["fedavg"]["mask"]),
                        ("all_masked", None)):
        block = {k: torch.from_numpy(v[lo:hi])
                 for k, v in spec["fedavg"]["stacked"].items()}
        counts = torch.from_numpy(spec["fedavg"]["counts"][lo:hi])
        if label == "all_masked":
            counts = torch.zeros_like(counts)
        out = fedavg_psum_shard_map(
            mesh, block, counts,
            None if mask is None else torch.from_numpy(mask[lo:hi]))
        fedavg[label] = {k: v.numpy() for k, v in out.items()}
    return {
        "fedavg": fedavg,
        "jax": {label: jax_comparable_round(cfg, spec["jax_init"], mesh)
                for label, cfg in spec["jax"].items()},
        "inventory": {label: inventory(mesh, inventory_config(**kw), fused)
                      for label, (kw, fused) in INVENTORY_CASES.items()},
        "audit": run_audit(mesh),
        "entry_points": entry_points(mesh),
        "collectives": collectives(mesh),
    }


def fedavg_inputs() -> dict:
    """The reference's tests/test_parallel_and_validators.py tree at 16
    clients (a leaf with a nested dict flattened to its key)."""
    C = 16
    rng = np.random.default_rng(0)
    stacked = {"a": rng.normal(size=(C, 8, 16)).astype(np.float32),
               "b/c": rng.normal(size=(C, 32)).astype(np.float32)}
    counts = rng.integers(10, 100, size=C).astype(np.float32)
    mask = (rng.random(C) > 0.3).astype(np.float32)
    return {"stacked": stacked, "counts": counts, "mask": mask}


def jax_engine(mesh=None, dp: bool = False):
    """The reference engine of :func:`jax_comparable_config` (imports
    JAX: the test process only)."""
    from fl_tpu.core.types import PrivacyConfig as JaxPrivacyConfig
    from fl_tpu.data import load_dataset as jax_load_dataset
    from fl_tpu.data import make_federated_arrays as jax_make_arrays
    from fl_tpu.fl.local_training import \
        FederatedTrainingConfig as JaxTrainingConfig
    from fl_tpu.models import create_model as jax_create_model
    from fl_tpu.orchestration import FederatedRoundEngine as JaxEngine
    from fl_tpu.orchestration import RoundEngineConfig as JaxConfig

    splits = jax_load_dataset("mnist", n_train_synth=JAX_CLIENTS * SPC,
                              n_test_synth=64)
    jarr = jax_make_arrays(splits, num_clients=JAX_CLIENTS, strategy="iid",
                           samples_per_client=SPC, seed=0)
    priv = (dict(dp_mode="delta",
                 privacy=JaxPrivacyConfig(epsilon=1e9, delta=1e-5,
                                          max_grad_norm=1.0),
                 epsilon_per_round=1e8, delta_per_round=1e-6)
            if dp else {})
    return JaxEngine(
        jax_create_model("simple_cnn", dropout_rate=0.0), jarr,
        JaxConfig(training=JaxTrainingConfig(local_epochs=2, batch_size=16,
                                             learning_rate=LR),
                  max_clients=JAX_CLIENTS, seed=5, **priv),
        mesh=mesh)


def jax_init_weights() -> dict:
    """The JAX engine's initial weights of the comparable configuration,
    as the port's flat weight dict (the port's rounds start from them)."""
    import jax

    params = jax.device_get(jax_engine().global_variables["params"])
    return {f"params/{layer}/{k}": np.asarray(v, np.float32)
            for layer in params for k, v in params[layer].items()}


def build_spec(part: str, workdir) -> dict:
    """The launch's inputs for one test file: ``"features"`` (the feature
    matrix's configs), ``"engines"`` (a directory under ``workdir`` for
    the checkpoints), ``"topologies"`` or ``"mesh"`` (everything
    else)."""
    if part == "engines":
        return {"engines": str(workdir)}
    if part == "topologies":
        return {"topologies": True}
    if part == "validation":
        return {"validation": str(workdir)}
    if part == "features":
        from fl_tpu.orchestration.features import FEATURES

        return {"features": {name: feature_config(name)
                             for name in FEATURES}}
    return {
        "fedavg": fedavg_inputs(),
        "jax": {"fedavg": jax_comparable_config(False),
                "delta_dp": jax_comparable_config(True)},
        "jax_init": jax_init_weights(),
    }


def mesh_results(tmp_path_factory, part: str) -> list:
    """Each rank's :func:`rank_job` result for one test file (``part``),
    computed once a test session: the first test process to ask runs the
    launch under a lock in the session's shared temporary directory, the
    others read its file."""
    from filelock import FileLock

    base = _session_base(tmp_path_factory)
    path = base / f"torch_mesh_{part}.pkl"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            results = spawn(rank_job, WORLD,
                            build_spec(part, mesh_workdir(tmp_path_factory,
                                                          part)))
            with open(path, "wb") as f:
                pickle.dump(results, f)
    with open(path, "rb") as f:
        return pickle.load(f)


def _session_base(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # shared by the session's xdist workers
    return base


def mesh_workdir(tmp_path_factory, part: str):
    """The directory a part's ranks write into (its checkpoints), under
    the session's shared temporary directory."""
    return _session_base(tmp_path_factory) / f"torch_mesh_{part}_files"
