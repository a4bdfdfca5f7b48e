"""Complete-system smoke test of the port
(``scripts/test_complete_system.py`` of the reference): the quick start's
checks, then data-loader statistics, quantization fidelity, the proto
messages, privacy and performance validation, robust aggregation, secure
aggregation's mask cancellation and the server optimizer's identity, run
on the port's objects. Prints one line a check and the count, and exits
0 only if every check passed.

Run: ``python -m fl_tpu_torch.experiments.complete_system
[--device cpu]``
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from fl_tpu_torch.experiments._common import add_port_flags, device_of
from fl_tpu_torch.experiments.quick_start import (
    check,
    test_compression_roundtrip,
    test_imports,
    test_model_creation,
    test_privacy_noise,
    test_three_client_fedavg,
)


def test_data_loader_statistics(device):
    from fl_tpu_torch.data import create_data_loader

    loader = create_data_loader("mnist", num_clients=4,
                                partition_strategy="non_iid",
                                n_train_synth=1024, n_test_synth=128)
    stats = loader.get_client_statistics()
    assert len(stats) == 4
    assert sum(s["num_samples"] for s in stats.values()) == 1024
    analysis = loader.analyze_distribution()
    assert analysis["mean_pairwise_tv_distance"] > 0


def test_quantization_fidelity(device):
    import numpy as np

    from fl_tpu_torch.fl.compression import create_compression_service

    svc = create_compression_service("quantization", bits=8)
    weights = {"w": np.random.default_rng(1).normal(
        size=(256,)).astype(np.float32)}
    payload, meta = svc.compress_weights(weights)
    restored = svc.decompress_weights(payload, meta)
    assert np.allclose(weights["w"], restored["w"],
                       atol=meta["tensors"]["w"]["scale"])


def test_proto_messages(device):
    from fl_tpu_torch.services import federated_learning_pb2 as pb

    update = pb.ModelUpdate(client_id="c1", round_number=2,
                            model_weights=b"\x00\x01", num_samples=10,
                            training_loss=0.5)
    blob = update.SerializeToString()
    back = pb.ModelUpdate.FromString(blob)
    assert back.client_id == "c1" and back.num_samples == 10
    status = pb.TrainingStatus(current_round=3, active_clients=5)
    assert pb.TrainingStatus.FromString(
        status.SerializeToString()).current_round == 3


def test_privacy_validation(device):
    from fl_tpu_torch.validation import PrivacyValidator

    v = PrivacyValidator(device=device)
    assert v.validate_privacy_budget_tracking()["passed"]
    assert v.validate_differential_privacy(dim=4096, trials=2,
                                           use_pallas=False)["passed"]


def test_performance_validation(device):
    from fl_tpu_torch.validation import (
        PerformanceRequirements,
        PerformanceValidator,
    )

    v = PerformanceValidator(samples_per_client=16, local_epochs=1,
                             batch_size=8,
                             requirements=PerformanceRequirements(
                                 max_latency_ms=120_000),
                             device=device)
    assert v.run_baseline_test(num_clients=2)["passed"]


def test_robust_aggregation(device):
    import math

    import torch

    from fl_tpu_torch.fl.robust_agg import median_matrix, trimmed_mean_matrix

    mat = torch.tensor([[1.0], [2.0], [3.0], [1e6]], dtype=torch.float32,
                       device=device)
    mask = torch.ones(4, dtype=torch.float32, device=device)
    assert float(trimmed_mean_matrix(mat, mask, 1)[0]) == 2.5
    assert float(median_matrix(mat, mask)[0]) == 2.5
    assert math.isfinite(float(median_matrix(mat, mask)[0]))


def test_secure_aggregation_cancellation(device):
    from fl_tpu_torch.fl.secure_agg import ring_pair_masks

    m = ring_pair_masks(0, 8, 130, neighbors=3, scale=4.0, device=device)
    assert abs(float(m.sum(dim=0).max())) < 1e-3
    assert float(m.abs().max()) > 1.0


def test_server_optimizer_identity(device):
    import torch

    from fl_tpu_torch.fl.server_optimizer import make_server_optimizer

    opt = make_server_optimizer("fedavgm", learning_rate=1.0, momentum=0.0)
    params = {"w": torch.tensor([1.0, 2.0], device=device)}
    avg = {"w": torch.tensor([0.5, 1.5], device=device)}
    new, _ = opt.update(params, avg, opt.init(params))
    torch.testing.assert_close(new["w"], avg["w"], rtol=1e-6, atol=0.0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fl_tpu_torch.experiments.complete_system")
    add_port_flags(p)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    device = device_of(build_parser().parse_args(argv))
    print("fl_tpu_torch complete-system checks:")
    results = [
        check(name, fn, device) for name, fn in (
            ("imports", test_imports),
            ("model creation", test_model_creation),
            ("differential privacy noise", test_privacy_noise),
            ("compression roundtrip", test_compression_roundtrip),
            ("3-client FedAvg", test_three_client_fedavg),
            ("data loader statistics", test_data_loader_statistics),
            ("quantization fidelity", test_quantization_fidelity),
            ("proto message construction", test_proto_messages),
            ("privacy validation", test_privacy_validation),
            ("performance validation", test_performance_validation),
            ("robust aggregation", test_robust_aggregation),
            ("secure aggregation mask cancellation",
             test_secure_aggregation_cancellation),
            ("server optimizer identity", test_server_optimizer_identity),
        )
    ]
    print(f"\n{sum(results)}/{len(results)} checks passed")
    return 0 if all(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
