"""Host → device copies that do not stall the host.

A copy from pageable host memory to a CUDA device waits for the device's
queue to drain before it returns, so a round loop that uploads its
participation mask or its per-client seeds that way cannot run ahead of
the device. :func:`to_device` stages the array in pinned memory and copies
it asynchronously, in stream order; the pinned buffer is kept until the
copy has run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def to_device(array, device, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """``array`` (numpy or anything ``np.asarray`` takes) as a tensor on
    ``device``, of ``dtype`` if given. On the CPU it may share the array's
    memory."""
    t = torch.as_tensor(np.asarray(array), dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
