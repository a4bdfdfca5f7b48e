"""Datasets and device-resident federated shards (port of fl_tpu.data)."""

from fl_tpu_torch.data.datasets import (  # noqa: F401
    DatasetSplits,
    load_dataset,
    MNIST_MEAN,
    MNIST_STD,
    CIFAR10_MEAN,
    CIFAR10_STD,
)
from fl_tpu_torch.data.federated import (  # noqa: F401
    FederatedArrays,
    FederatedDataset,
    analyze_data_distribution,
    make_federated_arrays,
)
from fl_tpu_torch.data.loader import (  # noqa: F401
    create_data_loader,
    FederatedDataLoader,
)
