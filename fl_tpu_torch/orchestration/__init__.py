"""The round engine (port of fl_tpu.orchestration)."""

from fl_tpu_torch.orchestration.round_engine import (  # noqa: F401
    FederatedRoundEngine,
    RoundEngineConfig,
    RoundResult,
)
