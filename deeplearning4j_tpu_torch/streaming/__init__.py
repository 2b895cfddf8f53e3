"""Streaming glue (the JAX package's ``streaming/``; reference
dl4j-streaming: Kafka + Camel routes for NDArray pub/sub and model
serving): the in-process and TCP brokers, the serving routes, the durable
request journal and the fleet's exactly-once ledger."""

from .fleet import FleetLedger
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
           "RecoveryReport", "recover_from_journal", "replay_journal"]
