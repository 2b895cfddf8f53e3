"""NDArray pub/sub — the JAX package's ``streaming/pubsub.py``, copied
(reference dl4j-streaming kafka/NDArrayKafkaClient.java, NDArrayPublisher,
NDArrayConsumer).

Kafka's role (durable topic fan-out of serialized NDArrays) is played by a
broker abstraction with an in-process implementation: named topics, each a
bounded deque fanned out to subscriber queues. The wire format is the same
``np.save`` framing the parameter server uses, so a Kafka-backed
implementation only has to re-implement :class:`MessageBroker` — publishers
and subscribers are transport-agnostic, mirroring how the reference hides
Kafka behind Camel routes.
"""

from __future__ import annotations

import io
import queue
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np


def serialize_ndarray(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return buf.getvalue()


def deserialize_ndarray(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


class MessageBroker:
    """In-process topic broker (Kafka stand-in)."""

    def __init__(self, capacity: int = 1024):
        self._subs: Dict[str, List[queue.Queue]] = defaultdict(list)
        self._lock = threading.Lock()
        self.capacity = capacity

    def publish(self, topic: str, payload: bytes) -> None:
        with self._lock:
            subs = list(self._subs[topic])
        for q in subs:
            try:
                q.put_nowait(payload)
            except queue.Full:
                # drop-oldest backpressure; every step races subscribers and
                # other publishers, so both ops tolerate losing the race
                # (worst case THIS message is the one dropped)
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                try:
                    q.put_nowait(payload)
                except queue.Full:
                    pass

    def subscribe(self, topic: str) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=self.capacity)
        with self._lock:
            self._subs[topic].append(q)
        return q

    def unsubscribe(self, topic: str, q: queue.Queue) -> None:
        with self._lock:
            if q in self._subs[topic]:
                self._subs[topic].remove(q)


class NDArrayPublisher:
    """reference NDArrayPublisher: push arrays onto a topic."""

    def __init__(self, broker: MessageBroker, topic: str):
        self.broker = broker
        self.topic = topic
        self._closed = False

    def publish(self, arr: np.ndarray) -> None:
        if self._closed:
            # a closed publisher fails loudly instead of silently feeding
            # a topic its route already tore down; _publish_safe callers
            # degrade this to a counted drop
            raise RuntimeError(f"publisher for '{self.topic}' is closed")
        self.broker.publish(self.topic, serialize_ndarray(arr))

    def close(self) -> None:
        """Release the publishing end (route ``stop()`` closes BOTH ends;
        transports with per-publisher state hook their teardown here)."""
        self._closed = True


class NDArraySubscriber:
    """reference NDArrayConsumer: pull (or callback-drain) arrays."""

    def __init__(self, broker: MessageBroker, topic: str):
        self.broker = broker
        self.topic = topic
        self._q = broker.subscribe(topic)
        self._stop = threading.Event()

    def poll(self, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        try:
            if timeout is None:
                return deserialize_ndarray(self._q.get_nowait())
            return deserialize_ndarray(self._q.get(timeout=timeout))
        except queue.Empty:
            return None

    def listen(self, callback: Callable[[np.ndarray], None]) \
            -> threading.Thread:
        """Background drain thread (Camel consumer-route analog)."""

        def run():
            while not self._stop.is_set():
                try:
                    payload = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                callback(deserialize_ndarray(payload))

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t

    def close(self):
        self._stop.set()
        self.broker.unsubscribe(self.topic, self._q)


# ------------------------------------------------------- broker drivers
# The reference swaps transports by Camel route configuration
# (kafka:... URIs); here a scheme-keyed driver registry plays that role:
# "memory://" is the in-process broker, and an external broker (Kafka,
# Redis, ...) drops in by registering a factory for its scheme — every
# publisher/subscriber/route stays transport-agnostic.

_BROKER_DRIVERS: Dict[str, Callable[..., MessageBroker]] = {}


def register_broker_driver(scheme: str,
                           factory: Callable[..., MessageBroker]) -> None:
    """Register ``factory(url, capacity) -> broker`` for ``scheme://``
    URLs. The broker contract is MessageBroker's surface:
    publish/subscribe/unsubscribe over bytes payloads."""
    _BROKER_DRIVERS[scheme.lower()] = factory


def broker_schemes():
    return sorted(_BROKER_DRIVERS)


def create_broker(url: str = "memory://",
                  capacity: int = 1024) -> MessageBroker:
    """Instantiate the broker for a ``scheme://...`` URL."""
    scheme = url.split("://", 1)[0].lower() if "://" in url else url.lower()
    if scheme not in _BROKER_DRIVERS:
        raise ValueError(
            f"no broker driver for scheme '{scheme}' "
            f"(registered: {broker_schemes()}); "
            "register one with register_broker_driver()")
    return _BROKER_DRIVERS[scheme](url, capacity)


register_broker_driver("memory",
                       lambda url, capacity: MessageBroker(capacity))


class NDArrayStreamClient:
    """Paired publisher/subscriber on one broker (NDArrayKafkaClient
    analog). Construct from an explicit broker instance or a driver URL
    (default: the in-process memory broker)."""

    def __init__(self, broker: Optional[MessageBroker] = None,
                 url: str = "memory://", capacity: int = 1024):
        self.broker = broker if broker is not None \
            else create_broker(url, capacity)

    def publisher(self, topic: str) -> NDArrayPublisher:
        return NDArrayPublisher(self.broker, topic)

    def subscriber(self, topic: str) -> NDArraySubscriber:
        return NDArraySubscriber(self.broker, topic)
