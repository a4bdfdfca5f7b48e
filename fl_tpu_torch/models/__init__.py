"""Models over stacked clients (port of fl_tpu.models)."""

from fl_tpu_torch.models.cifar10_cnn import (  # noqa: F401
    CIFAR10CNN,
    variables_from_flax,
    variables_to_flax,
)
from fl_tpu_torch.models.factory import (  # noqa: F401
    AVAILABLE_MODELS,
    ModelFactory,
    benchmark_models,
    create_model,
    get_lightweight_model,
    get_model_for_dataset,
    get_model_info,
    get_model_weights,
    init_variables,
    list_available_models,
    model_info,
    validate_model_compatibility,
)
from fl_tpu_torch.models.mobilenet import (  # noqa: F401
    LightweightMobileNet,
    MobileNetBlock,
)
from fl_tpu_torch.models.resnet import FederatedResNet, ResNetBlock  # noqa: F401
from fl_tpu_torch.models.simple_cnn import (  # noqa: F401
    SimpleCNN,
    count_params,
    load_feddyn_state,
    load_uplink_state,
    params_from_flax,
    params_to_flax,
)
from fl_tpu_torch.models.vit import EncoderBlock, FederatedViT  # noqa: F401
