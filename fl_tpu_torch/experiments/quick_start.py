"""Quick-start smoke test of the port: five checks
(``scripts/quick_start.py`` of the reference), run on the port's objects:
(1) imports, (2) model creation, (3) DP noise actually applied, (4) a
compression round trip, (5) 3-client FedAvg on dummy weights. Prints one
line a check and the count, and exits 0 only if every check passed.

Run: ``python -m fl_tpu_torch.experiments.quick_start [--device cpu]``
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from fl_tpu_torch.experiments._common import add_port_flags, device_of

PASS = "✓"
FAIL = "✗"


def check(name, fn, device):
    try:
        fn(device)
        print(f"  {PASS} {name}")
        return True
    except Exception as e:
        print(f"  {FAIL} {name}: {e}")
        return False


def test_imports(device):
    import fl_tpu_torch  # noqa: F401
    import fl_tpu_torch.fl.fedavg  # noqa: F401
    import fl_tpu_torch.fl.privacy  # noqa: F401
    import fl_tpu_torch.models  # noqa: F401
    import fl_tpu_torch.orchestration  # noqa: F401


def test_model_creation(device):
    from fl_tpu_torch.models import (create_model, init_variables,
                                     list_available_models)

    assert len(list_available_models()) == 4
    model = create_model("simple_cnn")
    variables = init_variables(model, seed=0, device=device)
    assert model.get_parameter_count(variables) == 421_642


def test_privacy_noise(device):
    import numpy as np
    import torch

    from fl_tpu_torch.fl.privacy import create_privacy_engine

    engine = create_privacy_engine(epsilon=1.0, delta=1e-5, device=device)
    grads = {"w": torch.full((512,), 0.001, dtype=torch.float32,
                             device=device)}
    noisy = engine.add_noise(grads, 1.0, 1e-5)
    assert not np.allclose(noisy["w"].cpu().numpy(), 0.001), \
        "noise not applied"
    assert engine.budget_tracker.consumed_epsilon == 1.0


def test_compression_roundtrip(device):
    import numpy as np

    from fl_tpu_torch.fl.compression import create_compression_service

    svc = create_compression_service("zlib")
    weights = {"w": np.random.default_rng(0).normal(
        size=(64, 32)).astype(np.float32)}
    payload, meta = svc.compress_weights(weights)
    restored = svc.decompress_weights(payload, meta)
    np.testing.assert_array_equal(weights["w"], restored["w"])


def test_three_client_fedavg(device):
    import numpy as np

    from fl_tpu_torch.core.types import ModelUpdate, to_numpy
    from fl_tpu_torch.fl.fedavg import FedAvgAggregator

    updates = [
        ModelUpdate(client_id=f"c{i}", round_number=0,
                    model_weights={"w": np.full((16,), float(i), np.float32)},
                    num_samples=100 * (i + 1), training_loss=0.5)
        for i in range(3)
    ]
    model = FedAvgAggregator(device=device).aggregate_updates(updates)
    # weighted mean: (100*0 + 200*1 + 300*2)/600 = 4/3
    np.testing.assert_allclose(to_numpy(model.model_weights["w"]),
                               4.0 / 3.0, rtol=1e-6)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fl_tpu_torch.experiments.quick_start")
    add_port_flags(p)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    device = device_of(build_parser().parse_args(argv))
    print("fl_tpu_torch quick start checks:")
    results = [
        check("imports", test_imports, device),
        check("model creation", test_model_creation, device),
        check("differential privacy noise", test_privacy_noise, device),
        check("compression roundtrip", test_compression_roundtrip, device),
        check("3-client FedAvg", test_three_client_fedavg, device),
    ]
    print(f"\n{sum(results)}/{len(results)} checks passed")
    return 0 if all(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
