"""Federated core: local training, delta and client-level DP with their
accountants, FedAvg, convergence, partitioning, compression (port of
fl_tpu.fl)."""
