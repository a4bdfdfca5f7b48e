"""Federated core: local training, delta and client-level DP with their
accountants, FedAvg, convergence, partitioning, compression (port of
fl_tpu.fl)."""

from fl_tpu_torch.fl.peft import (  # noqa: F401
    LoRADense,
    count_trainable,
    lora_trainable_patterns,
    merge_lora,
    trainable_mask,
)
