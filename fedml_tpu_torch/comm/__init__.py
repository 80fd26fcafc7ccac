"""The host-edge wire of the cross-silo federation (the port's copy of
``fedml_tpu/comm/``): the binary message codec, the transport SPI, the
in-process hub, the actor layer, seeded chaos and the retrying
transport.  The wire transports — `mqtt_transport` over the repo's own
broker and client, `grpc_transport` — are imported by name; neither is
imported here (``grpc`` is imported only when a `GrpcTransport` is
built)."""

from fedml_tpu_torch.comm.message import Message, SharedPayload, build_fanout
from fedml_tpu_torch.comm.transport import Observer, Transport
from fedml_tpu_torch.comm.local import LocalHub, LocalTransport
from fedml_tpu_torch.comm.actors import (NodeManager, ClientManager,
                                         ServerManager)
from fedml_tpu_torch.comm.chaos import (ChaosPlan, ChaosTransport, LinkChaos,
                                        Partition)
from fedml_tpu_torch.comm.resilient import ResilientTransport, RetryPolicy

__all__ = [
    "Message", "SharedPayload", "build_fanout",
    "Observer", "Transport", "LocalHub", "LocalTransport",
    "NodeManager", "ClientManager", "ServerManager",
    "ChaosPlan", "ChaosTransport", "LinkChaos", "Partition",
    "ResilientTransport", "RetryPolicy",
]
