"""The reference's headline inversion claim (``tests/test_inversion.py``)
on the port's harness (``fl_tpu_torch.validation.inversion``), on the CPU:
SimpleCNN (unfused) with the reference's init (``PRNGKey(0)``) carried
across, one synthetic-MNIST image, the report at the reference test's
1000 Adam steps with one restart (its two restarts double the time, 43 s
on one CPU thread, for 32.4 against one restart's 32.0 dB): the
non-private single-step release reconstructs the image (> 18 dB PSNR,
the exact label), the ε = 1 DP release does not (< 10 dB), a gap > 8 dB
(the reference measured 30.2 vs 3.7 dB, the port 32.0 vs 3.7). A file of
its own, to keep each under 60 s.
"""

import jax
import numpy as np
import pytest
import torch

from fl_tpu.data.synthetic import synthetic_mnist
from fl_tpu.models.factory import ModelFactory
from fl_tpu_torch.models import create_model
from fl_tpu_torch.models.simple_cnn import params_from_flax
from fl_tpu_torch.validation import inversion as inv

MEAN, STD = 0.1307, 0.3081


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module's tests and fixtures on one intra-op thread, restored
    after it: several test processes share the CPU under xdist, and idle
    OpenMP threads spinning in each starve the others' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def simple_cnn():
    """The port's SimpleCNN with the reference's weights at PRNGKey(0)."""
    jvars = ModelFactory.create_model("simple_cnn").init(
        jax.random.PRNGKey(0))
    return create_model("simple_cnn"), {
        "params": params_from_flax(jax.device_get(jvars["params"]))}


def test_inversion_report_reconstructs_and_dp_protects(simple_cnn):
    """tests/test_inversion.py's headline claim at its config."""
    model, variables = simple_cnn
    xtr, ytr, _, _ = synthetic_mnist(n_train=8, n_test=1, seed=3)
    rep = inv.inversion_report(
        model, variables, xtr[:1], ytr[:1], MEAN, STD, epsilon=1.0,
        delta=1e-5, max_norm=1.0,
        attack_config=inv.InversionAttackConfig(steps=1000, restarts=1),
        seed=0)
    assert rep["non_private"]["psnr_db"] > 18.0
    assert rep["non_private"]["label_accuracy"] == 1.0
    assert rep["dp"]["psnr_db"] < 10.0
    assert rep["psnr_gap_db"] > 8.0
    assert rep["protected"]
    assert rep["dp"]["noise_sigma"] > 0 and rep["non_private"][
        "noise_sigma"] == 0.0
    assert len(rep["non_private"]["restart_losses"]) == 1
