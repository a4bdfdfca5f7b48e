"""Deployment services (port of ``fl_tpu.services``): wire serialization,
proto converters, the gRPC coordinator servicer and client, the client
FSM, YAML config and the capability adapter.

Parity targets: proto/federated_learning.proto + src/shared/grpc_utils.py,
serialization.py; src/coordinator/grpc_server.py;
src/client/{grpc_client,federated_trainer}.py.

``serialization``, ``config``, ``capability_adapter``, ``grpc_client`` and
``federated_trainer`` import without ``grpcio`` or ``protobuf``; the
converters (``grpc_utils``), the generated messages and the servicer need
both. Secure aggregation and distributed DP over the wire, persistence,
the REST API and the command lines are not ported yet: they raise the
messages below.
"""

SECAGG_NOT_PORTED = (
    "secure aggregation and distributed DP over the wire come with the "
    "port's secure-aggregation slice (services/secagg_crypto.py, "
    "services/secagg_wire.py and the servicer's SecAgg RPCs), which is not "
    "ported yet")
PERSISTENCE_NOT_PORTED = (
    "persistence= comes with the port's persistence slice "
    "(services/rest_api.py, database.py, persistence.py), which is not "
    "ported yet")
