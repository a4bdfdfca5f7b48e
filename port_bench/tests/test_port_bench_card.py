"""On the card: the reference's copy of the release's noise stream
(``lib/philox.py``) equals what the port's K3 draws, element for element,
at the leaf groups of SimpleCNN's delta-DP release (a 401,408-wide group
and a 20,234-wide one) and at a width that is no multiple of four.

Run on a machine with an NVIDIA GPU: python3 -m pytest
port_bench/tests/test_port_bench_card.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))

from lib import philox, prng  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("width", [401408, 20234, 4099])
def test_card_noise_is_the_reference_copy(width):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K3 is a Triton kernel")
    from fl_tpu_torch.ops import dp

    clients = 8
    seeds = prng.client_stream_seeds(prng.fold(prng.root_seed(5), 0),
                                     clients, prng.DP_NOISE, 1)
    x = torch.zeros((clients, width), device="cuda")
    one = torch.ones(clients, device="cuda")
    got = dp.clip_noise_cuda(x, one, one, torch.as_tensor(
        np.asarray(seeds, np.uint64).view(np.int64)).cuda())
    want = philox.card_normals(seeds, width, "cuda")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
