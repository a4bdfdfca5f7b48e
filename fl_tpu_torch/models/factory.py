"""Model factory (port of ``fl_tpu.models.factory``; SimpleCNN only so far)."""

from __future__ import annotations

from typing import Any

from fl_tpu_torch.models.simple_cnn import SimpleCNN

AVAILABLE_MODELS = {"simple_cnn": SimpleCNN}
# dataset -> (model, its keyword arguments), for the models that are ported
_DATASET_MODELS = {"mnist": ("simple_cnn", {"num_classes": 10})}
# formulation flags of the reference's SimpleCNN that choose among XLA
# lowerings of the same values
_TPU_ONLY_FLAGS = ("fast_ops", "fast_pool_bwd", "fast_conv2_bwd",
                   "fast_stem_wgrad")


def create_model(model_name: str, **kwargs: Any):
    """Instantiate a model by registry name, e.g.
    ``create_model("simple_cnn", dtype=torch.bfloat16,
    fused_conv_block="residual")``."""
    if model_name not in AVAILABLE_MODELS:
        raise ValueError(
            f"Unknown model: {model_name}. Available: {list(AVAILABLE_MODELS)}")
    for flag in _TPU_ONLY_FLAGS:
        if flag in kwargs:
            raise ValueError(
                f"{flag} selects a TPU formulation of the reference model "
                "and is not ported; choose the conv segment with "
                "fused_conv_block (False, True or 'residual')")
    return AVAILABLE_MODELS[model_name](**kwargs)


def get_model_for_dataset(dataset: str, **kwargs: Any):
    """The recommended model for a dataset (the reference routes mnist to
    simple_cnn); only datasets whose model is ported are known."""
    dataset = dataset.lower()
    if dataset not in _DATASET_MODELS:
        raise ValueError(f"No ported model for dataset {dataset!r}. "
                         f"Available: {list(_DATASET_MODELS)}")
    name, defaults = _DATASET_MODELS[dataset]
    return create_model(name, **{**defaults, **kwargs})
