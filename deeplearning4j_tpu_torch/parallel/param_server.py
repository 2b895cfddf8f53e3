"""Asynchronous parameter-server data parallelism (the JAX package's
``parallel/param_server.py``; reference ParameterServerTrainer.java over
ND4J's VoidParameterServer).

The compute stays on the device: each worker fits its own replica. The
parameter-server plane is a host-side store of the flattened parameter
vector:

- ``InMemoryParameterServer``: a lock-guarded store in this process
  (worker threads);
- ``ParameterServerNode`` / ``ParameterServerClient``: the same store over
  TCP, 1-byte opcode (``P`` push, ``G`` get, ``Q`` quit) + big-endian u64
  length + ``np.save`` payload, the JAX package's wire format byte for
  byte, so a client of either package talks to a node of the other.

Aggregation is the reference's soft sync: a running average ``new = (1 -
alpha) * current + alpha * pushed`` with ``alpha = 1 / num_workers`` by
default; ``alpha = 1.0`` is last-writer-wins."""

from __future__ import annotations

import io
import logging
import socket
import struct
import threading
from typing import List, Optional

import numpy as np

_LOG = logging.getLogger(__name__)


# --------------------------------------------------------------------- store
class InMemoryParameterServer:
    """Host-side aggregate store for flattened parameter vectors."""

    def __init__(self, initial: np.ndarray, alpha: Optional[float] = None,
                 num_workers: int = 1):
        self._lock = threading.Lock()
        self._params = np.array(initial, dtype=np.float32, copy=True)
        self._alpha = float(alpha) if alpha is not None \
            else 1.0 / max(1, num_workers)
        self.pushes = 0

    def push(self, vector: np.ndarray) -> None:
        v = np.asarray(vector, dtype=np.float32)
        with self._lock:
            if v.shape != self._params.shape:
                raise ValueError(
                    f"push shape {v.shape} != server {self._params.shape}")
            self._params += self._alpha * (v - self._params)
            self.pushes += 1

    def pull(self) -> np.ndarray:
        with self._lock:
            return self._params.copy()

    # reference naming (ParameterServerClient.pushNDArray / getNDArray)
    push_ndarray = push
    get_ndarray = pull


# ----------------------------------------------------------------- transport
def _send_array(sock: socket.socket, op: bytes, arr: Optional[np.ndarray]):
    buf = io.BytesIO()
    if arr is not None:
        np.save(buf, np.asarray(arr, dtype=np.float32), allow_pickle=False)
    payload = buf.getvalue()
    sock.sendall(op + struct.pack(">Q", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("peer closed")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _recv_array(sock: socket.socket):
    op = _recv_exact(sock, 1)
    (ln,) = struct.unpack(">Q", _recv_exact(sock, 8))
    payload = _recv_exact(sock, ln) if ln else b""
    arr = np.load(io.BytesIO(payload), allow_pickle=False) if ln else None
    return op, arr


class ParameterServerNode:
    """TCP front-end around :class:`InMemoryParameterServer` on
    ``host:port`` (port 0: an ephemeral one, read back as ``self.port``)."""

    def __init__(self, initial: np.ndarray, host: str = "127.0.0.1",
                 port: int = 0, **kw):
        self.store = InMemoryParameterServer(initial, **kw)
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()
        self._srv.close()

    def _handle(self, conn: socket.socket):
        with conn:
            while True:
                try:
                    op, arr = _recv_array(conn)
                except (ConnectionError, struct.error):
                    return
                except ValueError as e:
                    # a corrupt .npy payload: the length-prefixed frame is
                    # consumed, so the stream stays in sync; keep serving
                    _LOG.warning("parameter server dropped corrupt frame: "
                                 "%s", e)
                    continue
                try:
                    if op == b"P":
                        if arr is None:
                            raise ValueError("push without payload")
                        self.store.push(arr)
                    elif op == b"G":
                        _send_array(conn, b"R", self.store.pull())
                    elif op == b"Q":
                        return
                except (ValueError, TypeError) as e:
                    # a bad frame must not kill the handler: drop the op
                    # (a push is fire-and-forget by protocol)
                    _LOG.warning("parameter server rejected %s op: %s", op,
                                 e)

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=2)


class ParameterServerClient:
    """Socket client mirroring ND4J's ``ParameterServerClient`` API. One
    connection carries strictly alternating request / response frames, so
    each round trip holds the lock (a slow server stalls concurrent
    callers: the client is a training-loop facade, not a serving path)."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self._lock = threading.Lock()

    # The lock held across socket I/O below is the PROTOCOL, not an
    # accident (GL010-annotated): one shared connection carries strictly
    # alternating request/response frames, so the whole round-trip must
    # be one critical section or two callers interleave frames. Callers
    # accept that a slow server stalls concurrent pushes — the client is
    # a training-loop-side facade, not a serving hot path.
    def push_ndarray(self, vector: np.ndarray) -> None:
        with self._lock:
            _send_array(self._sock, b"P", vector)   # graftlint: disable=GL010

    def get_ndarray(self) -> np.ndarray:
        with self._lock:
            _send_array(self._sock, b"G", None)   # graftlint: disable=GL010
            _, arr = _recv_array(self._sock)   # graftlint: disable=GL010
        return arr

    def close(self):
        try:
            with self._lock:
                _send_array(self._sock, b"Q", None)   # graftlint: disable=GL010
        except OSError:
            pass
        self._sock.close()


# ------------------------------------------------------------------ trainer
class ParameterServerTrainer:
    """One asynchronous worker: fit the replica on each fed batch, and
    every ``push_frequency`` batches push its parameters and pull the
    aggregate back into it (reference ParameterServerTrainer.java)."""

    def __init__(self, replica, server, push_frequency: int = 1):
        self.replica = replica
        self.server = server
        self.push_frequency = max(1, int(push_frequency))
        self._seen = 0

    def feed_dataset(self, ds) -> None:
        self.replica.fit([ds])
        self._seen += 1
        if self._seen % self.push_frequency == 0:
            self.server.push_ndarray(self.replica.params_flat())
            self.replica.set_params_flat(self.server.get_ndarray())


class ParameterServerParallelWrapper:
    """N asynchronous parameter-server workers, one thread each, each
    fitting a ``net.clone()`` on the net's device over every N-th batch;
    the final aggregate is written back into ``net``.

    ``backend``: ``"native"`` is the C++ store (``native_ps.py``; raises
    when it cannot be built), ``"python"`` the in-process store, ``"auto"``
    the native one when it builds, else the Python one (the JAX package's
    documented choice). ``self.backend`` records which was taken."""

    def __init__(self, net, num_workers: int = 2, push_frequency: int = 1,
                 alpha: Optional[float] = None, backend: str = "auto"):
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"backend '{backend}': expected 'auto', "
                             "'native' or 'python'")
        net._ensure_init()
        self.net = net
        self.num_workers = int(num_workers)
        self.server = None
        self.backend = "python"
        if backend in ("auto", "native"):
            from .native_ps import NativeParameterServer
            try:
                self.server = NativeParameterServer(
                    net.params_flat(), alpha=alpha, num_workers=num_workers)
                self.backend = "native"
            except (ImportError, OSError):
                if backend == "native":
                    raise
                _LOG.info("native parameter server unavailable; using the "
                          "Python store")
        if self.server is None:
            self.server = InMemoryParameterServer(
                net.params_flat(), alpha=alpha, num_workers=num_workers)
        self.push_frequency = push_frequency

    def fit(self, data, num_epochs: int = 1):
        from ..datasets.iterators import as_iterator
        replicas = [self.net.clone() for _ in range(self.num_workers)]
        trainers = [ParameterServerTrainer(r, self.server,
                                           self.push_frequency)
                    for r in replicas]
        for _ in range(num_epochs):
            batches: List = list(as_iterator(data))
            threads, errors = [], []
            for w, tr in enumerate(trainers):
                shard = batches[w::self.num_workers]

                def run(tr=tr, shard=shard):
                    try:
                        for ds in shard:
                            tr.feed_dataset(ds)
                    except BaseException as e:  # re-raised on the caller
                        errors.append(e)

                t = threading.Thread(target=run, daemon=True,
                                     name=f"ps-worker-{w}")
                t.start()
                threads.append(t)
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
        self.net.set_params_flat(self.server.pull())
        return self
