"""Models over stacked clients (port of fl_tpu.models)."""

from fl_tpu_torch.models.factory import (  # noqa: F401
    AVAILABLE_MODELS,
    create_model,
    get_model_for_dataset,
)
from fl_tpu_torch.models.simple_cnn import (  # noqa: F401
    SimpleCNN,
    count_params,
    load_feddyn_state,
    load_uplink_state,
    params_from_flax,
    params_to_flax,
)
