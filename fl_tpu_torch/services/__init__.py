"""Deployment services (port of ``fl_tpu.services``): wire serialization,
proto converters, the gRPC coordinator servicer and client, the client
FSM, secure aggregation over the wire (Bonawitz double masking with
Shamir dropout recovery, distributed DP over it), coordinator persistence
and restart resume on sqlite, the REST management API, the
``fl-coordinator`` / ``fl-client`` command lines, YAML config and the
capability adapter.

Parity targets: proto/federated_learning.proto + src/shared/grpc_utils.py,
serialization.py, database.py; src/coordinator/grpc_server.py,
rest_api.py, main.py; src/client/{grpc_client,federated_trainer,main}.py.

``serialization``, ``config``, ``capability_adapter``, ``grpc_client``,
``federated_trainer``, ``secagg_wire``, ``database``, ``persistence`` and
``rest_api`` import without ``grpcio`` or ``protobuf``; the converters
(``grpc_utils``), the generated messages and the servicer need both. The
secure-aggregation crypto imports ``cryptography`` at first use.
"""
