"""Configuration types, random streams and parameter-tree helpers (port of
fl_tpu.core)."""
