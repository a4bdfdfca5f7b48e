"""The check that a run measured the port alone: no module of JAX, of the
JAX package or of the repository's other benchmark and probe tools is
loaded. Names are compared by their whole top-level part (before the
first dot), so ``fl_tpu_torch`` passes and ``fl_tpu`` does not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "fl_tpu", "chip_smoke", "bench",
             "tools", "scripts")


def forbidden(names: Iterable[str] = None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))
