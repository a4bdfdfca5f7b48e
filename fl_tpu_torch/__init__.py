"""fl_tpu_torch — the PyTorch/CUDA port of fl_tpu for NVIDIA Hopper.

``fl_tpu`` (JAX, Pallas on a TPU) stays the reference; this package
mirrors its subpackage and module names so each counterpart is easy to
find, and imports torch and never JAX:

- ``fl_tpu_torch.core``          PrivacyConfig, random streams, tree helpers
- ``fl_tpu_torch.data``          datasets and device-resident client shards
- ``fl_tpu_torch.models``        SimpleCNN over stacked clients + factory
- ``fl_tpu_torch.ops``           hand-written Hopper kernels with their
                                 plain PyTorch versions: the fused conv
                                 segment (CUDA C++, ``csrc/``) and the DP
                                 clip+noise (Triton)
- ``fl_tpu_torch.fl``            local training, delta DP, client-level
                                 DP with the RDP and PLD accountants and
                                 adaptive clipping, FedAvg, convergence,
                                 partitioning, uplink compression with
                                 error feedback (int8, top-k, PowerSGD),
                                 the wire codecs, the topology engines,
                                 vertical FL and federated analytics
- ``fl_tpu_torch.native``        the LZ4 codec (C++, built by g++ at first
                                 use, bound with ctypes)
- ``fl_tpu_torch.orchestration`` the round engine, its checkpoints, the
                                 metrics collector and the simulation
                                 (``python -m fl_tpu_torch.orchestration.
                                 simulation``)
- ``fl_tpu_torch.parallel``      the client axis sharded over GPUs: one
                                 ``torch.distributed`` rank a shard
- ``fl_tpu_torch.validation``    the privacy, security and performance
                                 validators, the membership audit and the
                                 inversion, membership and poisoning
                                 attacks

Parameters keep the JAX layouts and flax names; client state is stacked
``(C, ...)`` tensors with the client axis written out.
"""

__version__ = "0.1.0"
