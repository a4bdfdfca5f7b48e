"""Validation harnesses (port of fl_tpu.validation): statistical DP
verification, security heuristics, performance and scalability tests,
the client-level membership audit, and the gradient-inversion,
membership-inference and poisoning attacks."""

from fl_tpu_torch.validation.privacy_validator import (  # noqa: F401
    ComprehensiveValidator,
    PrivacyValidator,
    SecurityValidator,
    validate_mnist_federated_learning,
)
from fl_tpu_torch.validation.performance_validator import (  # noqa: F401
    PerformanceRequirements,
    PerformanceValidator,
)
from fl_tpu_torch.validation.audit import (  # noqa: F401
    empirical_epsilon_lower_bound,
    run_client_membership_audit,
)
from fl_tpu_torch.validation.inversion import (  # noqa: F401
    InversionAttackConfig,
    evaluate_inversion_risk,
    inversion_report,
)
from fl_tpu_torch.validation.membership import (  # noqa: F401
    MembershipReport,
    evaluate_membership_risk,
    loss_attack_report,
    membership_advantage_bound,
    rank_auc,
)
from fl_tpu_torch.validation.poisoning import (  # noqa: F401
    evaluate_backdoor_robustness,
    evaluate_poisoning_robustness,
    poison_backdoor,
    poison_label_flip,
)
