"""The client axis over several GPUs (port of ``fl_tpu.parallel``).

``collectives`` holds FedAvg as one explicit all-reduce over the ranks of
a :class:`fl_tpu_torch.core.mesh.ClientMesh` and the communicator through
which the round engine's sharded superstep makes every cross-client
reduction, with its per-round inventory of calls. The reference's
``hlo_audit`` parses XLA's compiled HLO for the collectives a program
holds; the port issues its collectives itself, so the communicator counts
them where they are made instead.
"""

from fl_tpu_torch.parallel.collectives import (  # noqa: F401
    ClientAxis,
    Collective,
    Communicator,
    fedavg_psum_shard_map,
    make_sharded_fedavg,
)
