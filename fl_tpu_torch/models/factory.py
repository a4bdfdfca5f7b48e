"""Model factory and registry (port of ``fl_tpu.models.factory``), and the
flat weights view of a model's variables
(``fl_tpu.models.base.FLModel.get_model_weights``).

The dataset → model routing is the reference's: mnist → simple_cnn,
cifar10 → cifar10_cnn, cifar100 → federated_resnet (100 classes), any
other dataset → simple_cnn.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from fl_tpu_torch.core.pytree import (
    flatten_dict,
    tree_leaves,
    tree_map,
)
from fl_tpu_torch.models.cifar10_cnn import CIFAR10CNN
from fl_tpu_torch.models.mobilenet import LightweightMobileNet
from fl_tpu_torch.models.resnet import FederatedResNet
from fl_tpu_torch.models.simple_cnn import SimpleCNN
from fl_tpu_torch.models.vit import FederatedViT

AVAILABLE_MODELS = {
    "simple_cnn": SimpleCNN,
    "cifar10_cnn": CIFAR10CNN,
    "federated_resnet": FederatedResNet,
    "lightweight_mobilenet": LightweightMobileNet,
    "federated_vit": FederatedViT,
}
# models whose layers fix their input shape in the port
_FIXED_INPUT = ("simple_cnn", "cifar10_cnn")
_DATASET_INPUT_SHAPES = {
    "mnist": (28, 28, 1),
    "cifar10": (32, 32, 3),
    "cifar100": (32, 32, 3),
}
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


def create_model(model_name: str,
                 input_shape: Optional[Tuple[int, int, int]] = None,
                 **kwargs: Any):
    """Instantiate a model by registry name, e.g.
    ``create_model("simple_cnn", dtype=torch.bfloat16,
    fused_conv_block="residual")``, ``create_model("cifar10_cnn",
    norm="group")`` or ``create_model("federated_vit", lora_rank=4)``.
    ``input_shape`` (H, W, C) replaces the model's default; SimpleCNN and
    CIFAR10CNN are ported at their own shape only."""
    if model_name not in AVAILABLE_MODELS:
        raise ValueError(
            f"Unknown model: {model_name}. Available: {list(AVAILABLE_MODELS)}")
    flags, instead = _TPU_ONLY_FLAGS.get(model_name, ((), ""))
    for flag in flags:
        if flag in kwargs:
            raise ValueError(
                f"{flag} selects a TPU formulation of the reference model "
                f"and is not ported; {instead}")
    model = AVAILABLE_MODELS[model_name](**kwargs)
    if input_shape is not None and tuple(input_shape) != model.input_shape:
        if model_name in _FIXED_INPUT:
            raise ValueError(f"{model_name} is ported at input shape "
                             f"{model.input_shape} only, got {input_shape}")
        model.input_shape = tuple(input_shape)
    return model


def get_model_for_dataset(dataset: str, **kwargs: Any):
    """The recommended model for a dataset, as the reference routes it."""
    dataset = dataset.lower()
    shape = _DATASET_INPUT_SHAPES.get(dataset)
    if dataset == "mnist":
        return create_model("simple_cnn", input_shape=shape,
                            **{"num_classes": 10, **kwargs})
    if dataset == "cifar10":
        return create_model("cifar10_cnn", input_shape=shape,
                            **{"num_classes": 10, **kwargs})
    if dataset == "cifar100":
        return create_model("federated_resnet", input_shape=shape,
                            **{"num_classes": 100, **kwargs})
    return create_model("simple_cnn", **kwargs)


def get_lightweight_model(num_classes: int = 10, **kwargs: Any):
    """The low-resource preset: LightweightMobileNet at width 0.5."""
    return create_model("lightweight_mobilenet", num_classes=num_classes,
                        width_multiplier=0.5, **kwargs)


def list_available_models() -> List[str]:
    return list(AVAILABLE_MODELS)


def init_variables(model, seed: int = 0, device="cpu") -> Dict[str, Any]:
    """A model's unstacked variables, ``{"params": ..., "batch_stats":
    ...}`` (the statistics only where the model has them), from a seeded
    generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    variables = {"params": model.init(gen, device)}
    init_stats = getattr(model, "init_batch_stats", None)
    stats = init_stats(device) if init_stats is not None else None
    if stats is not None:
        variables["batch_stats"] = stats
    return variables


def model_info(model, variables: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """The reference's ``FLModel.get_model_info`` dict: name, parameter
    count, the variables' bytes (statistics included), the number of
    parameter leaves, trainable parameters, input shape, classes."""
    if variables is None:
        variables = init_variables(model)
    leaves = tree_leaves(variables["params"])
    n = sum(t.numel() for t in leaves)
    return {
        "name": model.name,
        "parameters": n,
        "memory_bytes": sum(t.numel() * t.element_size()
                            for t in tree_leaves(variables)),
        "layers": len(leaves),
        "trainable_params": n,
        "input_shape": tuple(model.input_shape),
        "num_classes": model.num_classes,
    }


def get_model_info(model_name: str) -> Dict[str, Any]:
    """Model metadata without keeping an instance around."""
    return model_info(create_model(model_name))


class ModelFactory:
    """Class-style facade matching the reference API."""

    AVAILABLE_MODELS = AVAILABLE_MODELS
    create_model = staticmethod(create_model)
    get_model_for_dataset = staticmethod(get_model_for_dataset)
    get_lightweight_model = staticmethod(get_lightweight_model)
    list_available_models = staticmethod(list_available_models)
    get_model_info = staticmethod(get_model_info)


def benchmark_models(batch_size: int = 1, num_classes: int = 10,
                     warmup: int = 1, iters: int = 5,
                     device="cuda") -> Dict[str, Dict[str, Any]]:
    """Time an eval-mode forward of every registered model on ``device``
    (one client, ``batch_size`` zero images), after ``warmup`` forwards:
    CUDA events around ``iters`` forwards on a card, the host clock on the
    CPU. Each entry is :func:`model_info`'s dict with ``inference_time``
    (seconds a forward), ``output_shape`` and ``device`` (the card's name,
    or "cpu"); a model that fails records ``{"error": ...}`` as in the
    reference."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    results: Dict[str, Dict[str, Any]] = {}
    for name in AVAILABLE_MODELS:
        try:
            model = create_model(name, num_classes=num_classes)
            variables = init_variables(model, device=device)
            stacked = tree_map(lambda t: t[None], variables)
            kw = ({"batch_stats": stacked["batch_stats"]}
                  if "batch_stats" in stacked else {})
            x = torch.zeros((1, batch_size) + tuple(model.input_shape),
                            device=device)

            @torch.no_grad()
            def fwd():
                return model(stacked["params"], x, **kw)

            for _ in range(max(1, warmup)):
                out = fwd()
            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                for _ in range(iters):
                    out = fwd()
                end.record()
                torch.cuda.synchronize(device)
                dt = start.elapsed_time(end) / 1e3 / iters
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    out = fwd()
                dt = (time.perf_counter() - t0) / iters
            info = model_info(model, variables)
            info["inference_time"] = dt
            info["output_shape"] = tuple(out.shape[1:])
            info["device"] = (torch.cuda.get_device_name(device) if on_card
                              else "cpu")
            results[name] = info
        except Exception as e:  # the reference records each failure
            results[name] = {"error": str(e)}
    return results


def validate_model_compatibility(model1, model2) -> bool:
    """True when two models can take part in the same FedAvg round: the
    same architecture, the same parameter paths and shapes."""
    try:
        if type(model1) is not type(model2):
            return False
        w1 = get_model_weights(init_variables(model1))
        w2 = get_model_weights(init_variables(model2))
        if set(w1) != set(w2):
            return False
        return all(w1[k].shape == w2[k].shape for k in w1)
    except Exception:
        return False


def get_model_weights(variables) -> Dict[str, Any]:
    """The flat ``{"params/conv1/kernel": tensor, "batch_stats/bn1/mean":
    ...}`` view of a variables dict: the trainable parameters and the batch
    statistics, which FedAvg also averages (the keys of
    ``fl_tpu.models.base.FLModel.get_model_weights``)."""
    return flatten_dict({k: v for k, v in variables.items()
                         if k in ("params", "batch_stats")})
