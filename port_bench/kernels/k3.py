"""Bytes of K3 (the DP clip and noise) in one round: every element of a
release read once and written once in f32. Delta DP releases each
client's whole variables tree (parameters and running statistics) once a
round; DP-SGD releases each client's parameter gradient once a local
step. About ten FLOPs an element, so the bytes bound it."""

import math


def elements(config, collections):
    return sum(math.prod(shape)
               for coll in collections
               for leaves in config.get(coll, {}).values()
               for shape, _ in leaves.values())


def bytes_per_round(config, workload):
    clients = workload["data"]["clients"]
    if workload["engine"]["dp_mode"] == "delta":
        return 8.0 * clients * elements(config, ("params", "batch_stats"))
    t = workload["training"]
    steps = t["local_epochs"] * max(
        1, workload["data"]["samples_per_client"] // t["batch_size"])
    return 8.0 * clients * steps * elements(config, ("params",))
