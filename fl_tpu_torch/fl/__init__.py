"""Federated core: local training, delta DP, FedAvg, convergence,
partitioning (port of fl_tpu.fl)."""
