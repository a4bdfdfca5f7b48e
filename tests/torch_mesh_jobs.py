"""The 2-rank runs of the port's sharded round engine that the mesh tests
read (``test_torch_mesh.py``, ``test_torch_mesh_features.py``).

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


def build_spec(part: str) -> dict:
    """The launch's inputs for one test file: ``"features"`` (the feature
    matrix's configs) or ``"mesh"`` (everything else)."""
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

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # shared by the session's xdist workers
    path = base / f"torch_mesh_{part}.pkl"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            results = spawn(rank_job, WORLD, build_spec(part))
            with open(path, "wb") as f:
                pickle.dump(results, f)
    with open(path, "rb") as f:
        return pickle.load(f)
