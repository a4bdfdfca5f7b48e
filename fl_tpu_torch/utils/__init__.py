"""Utilities (port of ``fl_tpu.utils``): structured logging, payload
validation, system monitoring, error tracking. Parity targets:
src/shared/logging_config.py, validation.py, monitoring.py,
error_tracking.py."""
