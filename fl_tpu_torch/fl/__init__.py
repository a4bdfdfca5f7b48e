"""Federated core: local training, delta and client-level DP with their
accountants, FedAvg, convergence, partitioning, compression, the
clustered (IFCA), Ditto, asynchronous (FedBuff), hierarchical (HierFAVG),
decentralized (D-PSGD), FedDF, federated-HPO and vertical (SplitNN)
engines, and federated analytics (port of fl_tpu.fl)."""

from fl_tpu_torch.fl.analytics import (  # noqa: F401
    AnalyticsResult,
    RandomizedResponse,
    dp_histogram,
    dp_quantiles,
    heavy_hitters,
)
from fl_tpu_torch.fl.async_fl import (  # noqa: F401
    AsyncConfig,
    AsyncFederatedEngine,
    AsyncStepResult,
)
from fl_tpu_torch.fl.clustered import (  # noqa: F401
    ClusteredConfig,
    ClusteredFederatedEngine,
    ClusteredRoundResult,
)
from fl_tpu_torch.fl.decentralized import (  # noqa: F401
    DecentralizedConfig,
    DecentralizedFederatedEngine,
    DecentralizedRoundResult,
    metropolis_mixing_matrix,
    ring_mixing_matrix,
    validate_mixing_matrix,
)
from fl_tpu_torch.fl.ditto import DittoPersonalizer  # noqa: F401
from fl_tpu_torch.fl.federated_eval import (  # noqa: F401
    evaluate_federated,
    make_federated_eval_fn,
)
from fl_tpu_torch.fl.feddf import (  # noqa: F401
    FedDFConfig,
    FedDFEngine,
    FedDFRoundResult,
)
from fl_tpu_torch.fl.hierarchical import (  # noqa: F401
    HierarchicalConfig,
    HierarchicalFederatedEngine,
    HierarchicalRoundResult,
)
from fl_tpu_torch.fl.hpo import (  # noqa: F401
    FederatedHPOEngine,
    HPOConfig,
    HPORoundResult,
    Trial,
)
from fl_tpu_torch.fl.peft import (  # noqa: F401
    LoRADense,
    count_trainable,
    lora_trainable_patterns,
    merge_lora,
    trainable_mask,
)
from fl_tpu_torch.fl.vertical import (  # noqa: F401
    VerticalConfig,
    VerticalFLEngine,
    split_features,
)
