"""Streaming glue (the JAX package's ``streaming/``; reference
dl4j-streaming: Kafka + Camel routes for NDArray pub/sub and model
serving): the in-process and TCP brokers, the serving routes, the durable
request journal, the engine fleet (router, membership, migration,
quarantine), the disaggregated prefill/decode tier and the burn-rate
autoscaler. The process-per-replica fleet (``remote.py``) is ROADMAP
queue A8c."""

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
           "PhaseAutoscaler"]
