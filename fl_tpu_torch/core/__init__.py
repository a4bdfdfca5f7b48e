"""Configuration types, random streams, the client mesh and parameter-tree
helpers (port of fl_tpu.core)."""
