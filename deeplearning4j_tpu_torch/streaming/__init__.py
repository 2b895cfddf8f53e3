"""Streaming glue (the JAX package's ``streaming/``; reference
dl4j-streaming: Kafka + Camel routes for NDArray pub/sub and model
serving): the in-process and TCP brokers, the serving routes, the durable
request journal, the engine fleet (router, membership, migration,
quarantine), the disaggregated prefill/decode tier, the burn-rate
autoscaler and the process-per-replica fleet (``remote.py``: every
replica its own OS process behind one ``FleetEndpoint``; its names load
on first use, so ``python -m deeplearning4j_tpu_torch.streaming.remote``,
a worker's entry point, does not find the module imported before it
runs)."""

from .autoscale import BurnRateAutoscaler
from .disagg import (InProcessKVTransport, KVTransport, KVTransportError,
                     PhaseAutoscaler, PhaseRouter, SerializedKVTransport)
from .fleet import (EngineFleetRouter, EngineReplica, FleetLedger,
                    FleetMembership, FleetRequest, KVFleetMembership,
                    REPLICA_ALIVE, REPLICA_CORRUPT, REPLICA_DEAD,
                    REPLICA_SUSPECT)
from .journal import (RecoveryReport, RequestJournal, recover_from_journal,
                      replay_journal)
from .pubsub import (MessageBroker, NDArrayPublisher, NDArraySubscriber,
                     NDArrayStreamClient, create_broker,
                     register_broker_driver)
from .serving import GenerationServingRoute, ModelServingRoute
from .tcp_broker import TcpBrokerServer, TcpMessageBroker  # registers tcp://

#: remote.py's names, resolved by __getattr__
_REMOTE = ("RpcFrameError", "RemoteReplicaError", "encode_rpc",
           "decode_rpc", "CoordinatorKVServer", "CoordinatorKVClient",
           "RemoteReplicaProxy", "ReplicaProcessLauncher",
           "RemoteFleetRouter", "FleetEndpoint")


__all__ = ["MessageBroker", "NDArrayPublisher", "NDArraySubscriber",
           "NDArrayStreamClient", "create_broker", "register_broker_driver",
           "ModelServingRoute", "GenerationServingRoute", "TcpBrokerServer",
           "TcpMessageBroker", "FleetLedger", "RequestJournal",
           "RecoveryReport", "recover_from_journal", "replay_journal",
           "EngineFleetRouter", "EngineReplica", "FleetMembership",
           "FleetRequest", "KVFleetMembership", "REPLICA_ALIVE",
           "REPLICA_SUSPECT", "REPLICA_DEAD", "REPLICA_CORRUPT",
           "BurnRateAutoscaler", "KVTransport", "KVTransportError",
           "InProcessKVTransport", "SerializedKVTransport", "PhaseRouter",
           "PhaseAutoscaler", *_REMOTE]

def __getattr__(name):
    if name in _REMOTE:
        from . import remote
        return getattr(remote, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
