"""Utilities: payload validation (port of ``fl_tpu.utils``; the logging,
monitoring and error-tracking modules come with the command-line
slice)."""
