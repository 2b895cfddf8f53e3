"""Cross-process TCP broker driver — the JAX package's
``streaming/tcp_broker.py``, copied (reference dl4j-streaming binds its
routes to a real external broker — kafka/NDArrayKafkaClient.java against
Kafka). Beside the in-process ``memory://`` broker, this ``tcp://`` broker
is the cross-process driver: publishers/subscribers/serving routes in
DIFFERENT processes meet at a small topic-fanout server.

Wire protocol (length-prefixed framing):

    frame := op(1) + u32 topic_len + topic_utf8 + u64 body_len + body

ops client→server: ``S`` subscribe, ``U`` unsubscribe, ``P`` publish;
server→client: ``M`` message (topic + payload fan-out to every connection
subscribed to the topic, including the publisher's own if subscribed —
Kafka topic semantics). The client class implements the MessageBroker
surface, so every publisher/subscriber/route runs unchanged over it.
"""

from __future__ import annotations

import itertools
import queue
import random
import socket
import struct
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

from ..observability.metrics import default_registry
from ..parallel.faults import NULL_INJECTOR
from .pubsub import MessageBroker, register_broker_driver

#: unique per-instance metric label suffixes (several clients/servers of
#: the same host:port coexist in tests; counters must stay per-instance)
_BROKER_SEQ = itertools.count()


def _shutdown_close(sock: socket.socket) -> None:
    """shutdown(SHUT_RDWR) then close: closing the fd alone does NOT
    wake a peer thread blocked in sendall on a full TCP window (or in
    recv) — and that sender holds ``_send_lock``, so every teardown and
    reconnect path MUST shutdown first or it deadlocks behind the
    wedged send for as long as the kernel retries."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _send_frame(sock: socket.socket, lock: threading.Lock, op: bytes,
                topic: str, body: bytes = b"") -> None:
    t = topic.encode("utf-8")
    frame = op + struct.pack(">I", len(t)) + t + \
        struct.pack(">Q", len(body)) + body
    with lock:
        # the lock serializes frame writes (interleaved sendalls corrupt
        # the length-prefixed protocol), so the send must happen under
        # it; it is bounded because close()/_reconnect() shutdown() the
        # fd, which wakes a sendall wedged on a stalled peer immediately
        sock.sendall(frame)   # graftlint: disable=GL010


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        c = sock.recv(min(n - len(buf), 1 << 20))
        if not c:
            raise ConnectionError("peer closed")
        buf += c
    return buf


def _recv_frame(sock: socket.socket) -> Tuple[bytes, str, bytes]:
    op = _recv_exact(sock, 1)
    (tlen,) = struct.unpack(">I", _recv_exact(sock, 4))
    topic = _recv_exact(sock, tlen).decode("utf-8")
    (blen,) = struct.unpack(">Q", _recv_exact(sock, 8))
    body = _recv_exact(sock, blen) if blen else b""
    return op, topic, body


class _Outbound:
    """Per-connection outbound queue drained by a dedicated writer thread.

    Publishing enqueues (never blocks): a subscriber that stops reading
    fills its TCP buffer, then its queue, and on overflow is DISCONNECTED
    — one stalled consumer can no longer head-of-line block delivery to
    every other subscriber or stop the server reading the publisher's
    socket (the blocking-sendall failure mode)."""

    def __init__(self, conn: socket.socket, max_queued: int = 256):
        self.conn = conn
        self.queue: "queue.Queue[Optional[bytes]]" = queue.Queue(max_queued)
        self.dropped = False
        self._lag = 0.0     # grace consumed across CONSECUTIVE congested
        self.thread = threading.Thread(target=self._drain, daemon=True)
        self.thread.start()   # sends; reset whenever the queue has room

    def _drain(self) -> None:
        while True:
            frame = self.queue.get()
            if frame is None:                # close sentinel
                return
            try:
                self.conn.sendall(frame)
            except OSError:
                return                       # reader side cleans up

    def send(self, frame: bytes, grace: float = 0.0) -> bool:
        """Enqueue; False means the consumer overflowed (caller should
        disconnect it). ``grace`` is a BUDGET of waiting for the writer
        to make progress on a FULL queue, accumulated across consecutive
        congested sends and reset whenever the queue has room again: a
        healthy consumer that is merely behind on a burst drains within
        it, while a stalled one (writer wedged in sendall on a full TCP
        window) or a chronically-too-slow one exhausts it and is evicted
        — so overflow-eviction means "no progress within grace", not
        "momentarily full" (which evicted healthy subscribers under
        scheduling jitter), and a slow-but-draining consumer cannot
        head-of-line-tax every frame forever."""
        try:
            self.queue.put_nowait(frame)
            self._lag = 0.0
            return True
        except queue.Full:
            pass
        budget = grace - self._lag
        if budget <= 0.0:
            self.dropped = True
            return False
        t0 = time.monotonic()
        try:
            self.queue.put(frame, timeout=budget)
            self._lag += time.monotonic() - t0
            return True
        except queue.Full:
            self.dropped = True
            return False

    def close(self) -> None:
        try:
            self.queue.put_nowait(None)
        except queue.Full:
            pass                             # writer dies with the socket


class TcpBrokerServer:
    """Topic-fanout server: one accept thread + one reader thread per
    connection + one writer thread per connection. Forwarding enqueues
    onto the subscriber's outbound queue (bounded, overflow =
    disconnect) so a stalled subscriber can't block other subscribers or
    the publisher's reader thread."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_queued_frames: int = 256,
                 overflow_grace: float = 0.25, registry=None):
        self._listener = socket.create_server((host, port))
        self.host, self.port = self._listener.getsockname()[:2]
        self._subs: Dict[str, Set[socket.socket]] = defaultdict(set)
        self._outs: Dict[socket.socket, _Outbound] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.max_queued_frames = int(max_queued_frames)
        # budget of waiting for writer progress (per consumer, per
        # congestion episode) before an overflow becomes an eviction; a
        # stalled or chronically slow peer exhausts it once and is
        # dropped, so it cannot head-of-line-block delivery indefinitely
        self.overflow_grace = float(overflow_grace)
        # stalled-subscriber evictions: a registry counter (the legacy
        # ``server.disconnects`` attribute is a property view)
        reg = registry if registry is not None else default_registry()
        self._m_disconnects = reg.counter(
            "broker_server_disconnects_total",
            "stalled-subscriber evictions performed",
            ("server",)).labels(f"{self.host}:{self.port}"
                                f"#s{next(_BROKER_SEQ)}")

    @property
    def disconnects(self) -> int:
        return int(self._m_disconnects.value)

    @property
    def url(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    def start(self) -> "TcpBrokerServer":
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        with self._lock:
            self._threads.append(t)
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                self._outs[conn] = _Outbound(conn, self.max_queued_frames)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            # prune finished per-connection threads so a long-lived server
            # doesn't leak one dead Thread object per connection ever made
            with self._lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)

    def _evict(self, conn: socket.socket) -> None:
        """Drop a dead/stalled connection from every topic and close it.
        shutdown() before close(): closing the fd alone does not wake a
        writer blocked in sendall on a full buffer (or the reader in
        recv) — both threads and the queued frames would leak."""
        with self._lock:
            for subs in self._subs.values():
                subs.discard(conn)
            out = self._outs.pop(conn, None)
        if out is not None:
            out.close()
        try:
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                op, topic, body = _recv_frame(conn)
                if op == b"S":
                    with self._lock:
                        self._subs[topic].add(conn)
                elif op == b"U":
                    with self._lock:
                        self._subs[topic].discard(conn)
                elif op == b"P":
                    t = topic.encode("utf-8")
                    frame = b"M" + struct.pack(">I", len(t)) + t + \
                        struct.pack(">Q", len(body)) + body
                    with self._lock:
                        targets = [(c, self._outs.get(c))
                                   for c in self._subs[topic]]
                    for c, out in targets:
                        if out is None or \
                                not out.send(frame,
                                             grace=self.overflow_grace):
                            # overflowed (stalled) or already gone: evict
                            # (counter child is internally locked —
                            # racing reader threads stay exact)
                            self._m_disconnects.inc()
                            self._evict(c)
        except (ConnectionError, struct.error, OSError):
            pass
        finally:
            self._evict(conn)

    def close(self) -> None:
        self._stop.set()
        self._listener.close()
        # close live connections so peers see EOF instead of a silent void
        with self._lock:
            conns = list(self._outs)
        for c in conns:
            with self._lock:
                out = self._outs.pop(c, None)
            if out is not None:
                out.close()
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()


class TcpMessageBroker(MessageBroker):
    """MessageBroker over a TcpBrokerServer connection. Local fan-out
    mirrors the in-process broker (bounded per-subscriber queues with
    drop-oldest backpressure); the server-side subscription is held while
    ANY local queue wants the topic (refcounted).

    Resilience: with ``reconnect=True`` (default) a lost
    connection triggers auto-reconnect in the reader thread —
    exponential backoff + jitter up to ``max_reconnect_attempts`` — and
    on success every topic with live local subscribers is RE-SUBSCRIBED
    server-side, so consumers ride through a broker restart. Publishers
    that hit a dead socket wait for the reconnect (bounded retries with
    backoff) instead of failing on the first broken frame; frames sent
    while the broker is down are lost (at-most-once, Kafka-less
    semantics) and the retry itself is counted in ``publish_retries``.
    ``fault_injector`` arms ``broker.send`` / ``broker.recv``
    (parallel/faults.py): an injected raise exercises exactly the
    reconnect/retry paths a real dead socket would.

    Partition hardening: a black-holed peer — SIGSTOP'd
    process or silently dropped packets, NOT an RST — lets the TCP
    buffer fill and then wedges ``sendall`` forever. ``publish_deadline``
    bounds that: it arms a kernel-level ``SO_SNDTIMEO`` on every socket
    (send-side only, so the reader's blocking recv is untouched) and
    acts as a wall budget per publish() call; on expiry the frame is
    DROPPED and counted in ``broker_publish_drops_total`` — the
    documented at-most-once degradation — and the poisoned socket (a
    timed-out sendall may have written a partial frame) is shut down so
    the reader reconnects. ``connect_timeout`` bounds the initial dial
    and every reconnect dial."""

    def __init__(self, host: str, port: int, capacity: int = 1024,
                 reconnect: bool = True, max_reconnect_attempts: int = 20,
                 backoff_base: float = 0.05, backoff_cap: float = 2.0,
                 publish_max_retries: int = 8, fault_injector=None,
                 registry=None, flight_recorder=None,
                 connect_timeout: float = 10.0,
                 publish_deadline: Optional[float] = 5.0):
        super().__init__(capacity)
        self.host, self.port = host, int(port)
        self.reconnect = bool(reconnect)
        self.max_reconnect_attempts = int(max_reconnect_attempts)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.publish_max_retries = int(publish_max_retries)
        self.connect_timeout = float(connect_timeout)
        self.publish_deadline = None if publish_deadline is None \
            else float(publish_deadline)
        self._faults = fault_injector if fault_injector is not None \
            else NULL_INJECTOR
        # reconnect breadcrumbs land on the flight recorder —
        # injectable like every other sink, so a round-private recorder
        # sees broker flaps on the same timeline as the crash they often
        # precede; lazily defaulted so construction stays import-light
        self._flightrec = flight_recorder
        self._sock = socket.create_connection((host, port),
                                              timeout=self.connect_timeout)
        self._sock.settimeout(None)
        self._arm_send_deadline(self._sock)
        self._send_lock = threading.Lock()
        # guards the self._sock REFERENCE only (reconnect swap vs close
        # teardown) — never held across I/O, so close() can always take
        # it even while a sender is wedged in sendall under _send_lock
        self._sock_lock = threading.Lock()
        # serializes the (refcount check, queue mutation, S/U frame) unit —
        # without it a concurrent last-unsubscribe + first-subscribe could
        # leave a live local queue with no server-side subscription. The
        # reader thread only takes it in _reconnect, where delivery is
        # necessarily idle (the connection is down), so no deadlock.
        self._sub_lock = threading.Lock()
        # resilience counters on the registry: per-instance
        # labels keep test assertions exact; the legacy attributes
        # (``client.reconnects`` / ``client.publish_retries``) are
        # property views
        reg = registry if registry is not None else default_registry()
        label = f"{host}:{port}#c{next(_BROKER_SEQ)}"
        self._m_reconnects = reg.counter(
            "broker_reconnects_total", "successful re-connections",
            ("broker",)).labels(label)
        self._m_publish_retries = reg.counter(
            "broker_publish_retries_total",
            "publishes that had to wait/retry through an outage",
            ("broker",)).labels(label)
        self._m_publish_drops = reg.counter(
            "broker_publish_drops_total",
            "frames dropped at the publish wall deadline (black-holed "
            "peer or outage outlasting the budget)",
            ("broker",)).labels(label)
        # deterministic jitter stream: chaos runs stay reproducible
        self._jitter = random.Random(0xC0FFEE ^ self.port)
        self._conn_ok = threading.Event()   # cleared while reconnecting
        self._conn_ok.set()
        self._closed = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _arm_send_deadline(self, sock: socket.socket) -> None:
        """Kernel-level SO_SNDTIMEO: bounds a single sendall against a
        black-holed peer WITHOUT settimeout(), which would also flip the
        reader's recv on the same socket to non-blocking semantics."""
        if self.publish_deadline is None:
            return
        sec = int(self.publish_deadline)
        usec = int(round((self.publish_deadline - sec) * 1e6))
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            struct.pack("ll", sec, usec))
        except (OSError, AttributeError):
            pass    # platform without SO_SNDTIMEO: wall check still holds

    # MessageBroker surface -------------------------------------------------
    def publish(self, topic: str, payload: bytes) -> None:
        attempts = 0
        wall = None if self.publish_deadline is None \
            else time.monotonic() + self.publish_deadline
        while True:
            try:
                if self._faults.fire("broker.send"):
                    return               # injected frame drop (lossy link)
                _send_frame(self._sock, self._send_lock, b"P", topic,
                            payload)
                return
            except (OSError, ConnectionError) as e:
                if self._closed.is_set() or not self.reconnect:
                    raise
                timed_out = isinstance(e, (socket.timeout,
                                           BlockingIOError,
                                           InterruptedError))
                if timed_out:
                    # SO_SNDTIMEO fired mid-sendall: a partial frame may
                    # be on the wire, so the socket's framing is poisoned
                    # — kill it; the reader's recv fails and reconnects
                    with self._sock_lock:
                        sock = self._sock
                    _shutdown_close(sock)
                attempts += 1
                self._m_publish_retries.inc()
                over_wall = wall is not None and time.monotonic() >= wall
                if attempts > self.publish_max_retries or over_wall:
                    if over_wall:
                        # wall deadline: degrade to a counted drop (the
                        # documented at-most-once loss) instead of
                        # wedging the pump thread for the whole outage
                        self._m_publish_drops.inc()
                        return
                    raise
                backoff = min(self.backoff_base * (2 ** attempts),
                              self.backoff_cap)
                if wall is not None:
                    backoff = min(backoff, max(wall - time.monotonic(),
                                               0.01))
                if self._conn_ok.is_set():
                    # the reader hasn't observed the outage yet (or the
                    # fault was injected on a healthy socket): waiting on
                    # a SET event returns instantly, so sleep the real
                    # backoff instead of burning every retry at once
                    time.sleep(backoff)
                else:
                    self._conn_ok.wait(timeout=backoff)

    def subscribe(self, topic: str) -> queue.Queue:
        with self._sub_lock:
            with self._lock:
                first = not self._subs[topic]
            q = super().subscribe(topic)
            if first:
                try:
                    # under _sub_lock by design: the (refcount check,
                    # queue mutation, S frame) unit must be atomic or a
                    # racing last-unsubscribe strands a live queue with
                    # no server-side subscription; the nested send is
                    # bounded (teardown shutdown()s the fd)
                    # graftlint: disable=GL010
                    _send_frame(self._sock, self._send_lock, b"S", topic)
                except OSError:
                    if not self.reconnect:
                        raise
                    # connection is down: the local queue is registered,
                    # so _reconnect() re-subscribes this topic on success
        return q

    def unsubscribe(self, topic: str, q: queue.Queue) -> None:
        with self._sub_lock:
            super().unsubscribe(topic, q)
            with self._lock:
                empty = not self._subs[topic]
            if empty and not self._closed.is_set():
                try:
                    # same atomic-unit argument as subscribe()
                    # graftlint: disable=GL010
                    _send_frame(self._sock, self._send_lock, b"U", topic)
                except OSError:
                    pass

    # ----------------------------------------------------------------------
    def _read_loop(self) -> None:
        while not self._closed.is_set():
            try:
                drop = self._faults.fire("broker.recv")
                op, topic, body = _recv_frame(self._sock)
            except (ConnectionError, struct.error, OSError):
                if self._closed.is_set() or not self.reconnect:
                    return
                if not self._reconnect():
                    return
                continue
            if drop:
                continue                 # injected frame drop (lossy link)
            if op == b"M":
                # local fan-out via the in-process broker's delivery
                # (drop-oldest bounded queues)
                MessageBroker.publish(self, topic, body)

    def _reconnect(self) -> bool:
        """Reader-thread only: tear down the dead socket, dial with
        exponential backoff + jitter, re-subscribe live topics."""
        self._conn_ok.clear()
        # shutdown-then-close: a publisher wedged in sendall on the dead
        # socket HOLDS _send_lock; plain close() would not wake it and
        # the swap below would block behind it for the whole outage
        _shutdown_close(self._sock)
        delay = self.backoff_base
        for _ in range(self.max_reconnect_attempts):
            if self._closed.is_set():
                return False
            try:
                s = socket.create_connection((self.host, self.port),
                                             timeout=self.connect_timeout)
                s.settimeout(None)
                self._arm_send_deadline(s)
            except OSError:
                time.sleep(min(delay, self.backoff_cap) *
                           (1.0 + 0.25 * self._jitter.random()))
                delay *= 2
                continue
            with self._sock_lock:
                if self._closed.is_set():
                    # close() ran mid-dial and could only tear down the
                    # OLD socket: this fresh one is ours to kill, or a
                    # publisher wedged on it could never be woken
                    _shutdown_close(s)
                    return False
                self._sock = s
            try:
                # re-subscribe every topic with live local subscribers:
                # consumers must not silently stop receiving after a
                # broker restart
                with self._sub_lock:
                    with self._lock:
                        topics = [t for t, qs in self._subs.items() if qs]
                    for t in topics:
                        # under _sub_lock by design: re-subscription must
                        # not interleave with a concurrent (un)subscribe
                        # or the refcount and the server state diverge;
                        # delivery is idle (connection was down) and the
                        # send is bounded (teardown shutdown()s the fd)
                        # graftlint: disable=GL010
                        _send_frame(s, self._send_lock, b"S", t)
            except OSError:
                # fresh socket died before the S frames landed (flapping
                # broker): tear it down (shutdown first — a publisher
                # may ALREADY be wedged in sendall on it holding
                # _send_lock) and back off like a failed dial — never a
                # tight redial loop
                _shutdown_close(s)
                time.sleep(min(delay, self.backoff_cap) *
                           (1.0 + 0.25 * self._jitter.random()))
                delay *= 2
                continue
            self._m_reconnects.inc()
            # flight-recorder breadcrumb: broker flaps right
            # before a crash are exactly what a post-mortem needs to see
            fr = self._flightrec
            if fr is None:
                from ..observability.flightrec import \
                    default_flight_recorder
                fr = default_flight_recorder()
            fr.record("reconnect", host=self.host, port=self.port)
            self._conn_ok.set()
            return True
        return False

    @property
    def reconnects(self) -> int:
        return int(self._m_reconnects.value)

    @property
    def publish_retries(self) -> int:
        return int(self._m_publish_retries.value)

    @property
    def publish_drops(self) -> int:
        return int(self._m_publish_drops.value)

    def close(self) -> None:
        self._closed.set()
        self._conn_ok.set()              # unblock publishers: they fail
        # fast instead of waiting out a reconnect that will never come;
        # shutdown-then-close also wakes a publisher wedged mid-sendall
        # (which holds _send_lock) instead of stranding it. The ref is
        # read under _sock_lock so a close racing _reconnect's swap
        # tears down whichever socket wins — the loser is killed by
        # _reconnect's pre-swap _closed check, which shares the same
        # _sock_lock critical section as the swap itself.
        with self._sock_lock:
            sock = self._sock
        _shutdown_close(sock)


def _tcp_driver(url: str, capacity: int) -> TcpMessageBroker:
    rest = url.split("://", 1)[1]
    host, _, port = rest.partition(":")
    if not port:
        raise ValueError(f"tcp broker URL needs host:port, got {url!r}")
    return TcpMessageBroker(host or "127.0.0.1", int(port), capacity)


register_broker_driver("tcp", _tcp_driver)
