"""Validation harnesses (port of fl_tpu.validation): so far the one-run
client-level membership audit."""

from fl_tpu_torch.validation.audit import (  # noqa: F401
    empirical_epsilon_lower_bound,
    run_client_membership_audit,
)
