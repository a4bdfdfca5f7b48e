"""Model factory (port of ``fl_tpu.models.factory`` for the ported models:
SimpleCNN and CIFAR10CNN), and the flat weights view of a model's
variables (``fl_tpu.models.base.FLModel.get_model_weights``)."""

from __future__ import annotations

from typing import Any, Dict

from fl_tpu_torch.core.pytree import flatten_dict
from fl_tpu_torch.models.cifar10_cnn import CIFAR10CNN
from fl_tpu_torch.models.simple_cnn import SimpleCNN

AVAILABLE_MODELS = {"simple_cnn": SimpleCNN, "cifar10_cnn": CIFAR10CNN}
# dataset -> (model, its keyword arguments), for the models that are ported
_DATASET_MODELS = {"mnist": ("simple_cnn", {"num_classes": 10}),
                   "cifar10": ("cifar10_cnn", {"num_classes": 10})}
# formulation flags of the reference's models that choose among XLA
# lowerings of the same values, and what the port chooses with instead
_TPU_ONLY_FLAGS = {
    "simple_cnn": (("fast_ops", "fast_pool_bwd", "fast_conv2_bwd",
                    "fast_stem_wgrad"),
                   "choose the conv segment with fused_conv_block (False, "
                   "True or 'residual')"),
    "cifar10_cnn": (("fast_pool_bwd",),
                    "the library max pool already routes a tied window's "
                    "gradient to its first maximum"),
}


def create_model(model_name: str, **kwargs: Any):
    """Instantiate a model by registry name, e.g.
    ``create_model("simple_cnn", dtype=torch.bfloat16,
    fused_conv_block="residual")`` or ``create_model("cifar10_cnn",
    norm="group")``."""
    if model_name not in AVAILABLE_MODELS:
        raise ValueError(
            f"Unknown model: {model_name}. Available: {list(AVAILABLE_MODELS)}")
    flags, instead = _TPU_ONLY_FLAGS[model_name]
    for flag in flags:
        if flag in kwargs:
            raise ValueError(
                f"{flag} selects a TPU formulation of the reference model "
                f"and is not ported; {instead}")
    return AVAILABLE_MODELS[model_name](**kwargs)


def get_model_for_dataset(dataset: str, **kwargs: Any):
    """The recommended model for a dataset, as the reference routes it
    (mnist → simple_cnn, cifar10 → cifar10_cnn); only datasets whose model
    is ported are known."""
    dataset = dataset.lower()
    if dataset not in _DATASET_MODELS:
        raise ValueError(f"No ported model for dataset {dataset!r}. "
                         f"Available: {list(_DATASET_MODELS)}")
    name, defaults = _DATASET_MODELS[dataset]
    return create_model(name, **{**defaults, **kwargs})


def get_model_weights(variables) -> Dict[str, Any]:
    """The flat ``{"params/conv1/kernel": tensor, "batch_stats/bn1/mean":
    ...}`` view of a variables dict: the trainable parameters and the batch
    statistics, which FedAvg also averages (the keys of
    ``fl_tpu.models.base.FLModel.get_model_weights``)."""
    return flatten_dict({k: v for k, v in variables.items()
                         if k in ("params", "batch_stats")})
