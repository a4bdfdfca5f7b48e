"""Model factory (port of ``fl_tpu.models.factory``; SimpleCNN only so far)."""

from __future__ import annotations

from typing import Any

from fl_tpu_torch.models.simple_cnn import SimpleCNN

AVAILABLE_MODELS = {"simple_cnn": SimpleCNN}


def create_model(model_name: str, **kwargs: Any):
    """Instantiate a model by registry name, e.g.
    ``create_model("simple_cnn", dtype=torch.bfloat16, dropout_rate=0.25)``."""
    if model_name not in AVAILABLE_MODELS:
        raise ValueError(
            f"Unknown model: {model_name}. Available: {list(AVAILABLE_MODELS)}")
    return AVAILABLE_MODELS[model_name](**kwargs)
