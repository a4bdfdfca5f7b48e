"""The round engine and its checkpoints (port of fl_tpu.orchestration)."""

from fl_tpu_torch.orchestration.checkpoint import (  # noqa: F401
    restore_async_checkpoint,
    restore_clustered_checkpoint,
    restore_ditto_checkpoint,
    restore_engine_checkpoint,
    save_async_checkpoint,
    save_clustered_checkpoint,
    save_ditto_checkpoint,
    save_engine_checkpoint,
)
from fl_tpu_torch.orchestration.round_engine import (  # noqa: F401
    FederatedRoundEngine,
    RoundEngineConfig,
    RoundResult,
)
from fl_tpu_torch.orchestration.selection import OortSelector  # noqa: F401
