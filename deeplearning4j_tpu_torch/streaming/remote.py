"""Process-per-replica fleet: every replica its own OS process, served
over the wire (the JAX package's ``streaming/remote.py``).

An in-process fleet (``streaming/fleet.py``) runs N replicas as serve
threads of one Python process: one fault domain (a host death takes the
router, the ledger and every replica), and the threads trade the
interpreter lock at every torch operator. This module puts each replica
in a process of its own, with the wire pieces the port already has —
the CRC-framed TCP broker, coordinator-KV membership, the SIGKILL-
surviving journal, ``FleetLedger`` fencing and checksummed KV page
frames:

- :func:`encode_rpc` / :func:`decode_rpc` — the dispatch / result
  framing: magic + version + CRC-protected JSON header + CRC-protected
  body, byte-identical to the JAX package's. A truncated, bit-flipped or
  hostile-length frame raises the typed :class:`RpcFrameError`, never
  crashes a pump thread; a duplicated frame is fenced by request id
  downstream.
- :class:`CoordinatorKVServer` / :class:`CoordinatorKVClient` — a small
  write-once KV store with the coordinator client surface
  (``key_value_set`` / ``key_value_dir_get`` / ``key_value_delete``), so
  :class:`~.fleet.KVFleetMembership` runs unchanged across processes:
  workers beat into it over TCP, the router's monitor ages the rows.
- :class:`RemoteReplicaProxy` — the router-side stand-in for a worker's
  engine. It has the bare-engine surface :class:`~.fleet.EngineReplica`
  wraps, so :class:`~.fleet.EngineFleetRouter` drives remote processes
  unchanged. Dispatches are re-published until ACKed (workers dedup by
  request id), and results are triple-fenced: the worker epoch (a stale
  incarnation's result is dropped), the pending-map identity (a result
  for a migrated-away id is unsolicited) and the shared ledger.
- :class:`ReplicaProcessLauncher` — spawns each replica with
  ``subprocess.Popen`` (``python -m
  deeplearning4j_tpu_torch.streaming.remote <config.json>``; never a
  fork of a process that may hold a CUDA context), restarts it with
  exponential backoff under a budget, drains it with SIGTERM through the
  worker's own ``PreemptionHandler``, and SIGSTOPs / SIGCONTs it for
  partition rounds. A worker serves on the CUDA card unless its config's
  ``device`` says ``"cpu"``.
- :class:`RemoteFleetRouter` — an :class:`~.fleet.EngineFleetRouter`
  over proxies plus the cross-process KV handoff: a prefill worker
  serializes its slot's pages (``PageFrameSet.to_bytes``), the router
  fences the handoff with ``try_reassign_from`` and forwards the bytes
  unparsed to a decode worker, whose ``from_bytes`` intake checks the
  frame CRCs and content checksums. Payload, wire bytes and pages are
  counted exactly.
- :class:`FleetEndpoint` — the front tier: broker server, coordinator
  KV server, launcher and router, so N worker processes look like one
  submit endpoint; ``scale_up`` / ``retire`` map to spawn / drain.
- :class:`RemoteWorker` / :func:`worker_main` — the replica process: a
  journaled :class:`~..models.generation.SlotGenerationEngine` on the
  model dict's seeded weights. In place of the JAX worker's compile
  audit it reports the port's build account (``cuda_lib.nvcc_runs()``, the
  decoder's ``param_casts``) and its own kernel launch counts
  (:func:`kernel_launches`) in its stats pushes and its ``drained``
  report: a worker's launches happen in its own process, where the
  parent's counters never see them.

Partition semantics: a SIGSTOPped worker's beats stop, the router ages
it SUSPECT → DEAD and clone-migrates its streams; when it resumes, its
late results hit the three fences and are counted
(``fenced_results`` / ``stale_epoch``), never served.

The chaos rounds are ``python -m deeplearning4j_tpu_torch.tools.chaos_soak
--remote`` (and ``--remote-scale``).
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..observability.clock import interval_now
from ..observability.flightrec import default_flight_recorder
from ..observability.metrics import default_registry
from ..parallel.faults import Cancelled, DeadlineExceeded, RejectedError
from .disagg import ROLE_DECODE, ROLE_PREFILL
from .fleet import EngineFleetRouter, KVFleetMembership
from .tcp_broker import TcpBrokerServer, TcpMessageBroker

#: when this module began to run: a worker's boot account starts here
_MODULE_T0 = time.monotonic()

__all__ = [
    "RpcFrameError", "RemoteReplicaError", "encode_rpc", "decode_rpc",
    "CoordinatorKVServer", "CoordinatorKVClient", "RouterSideMembership",
    "RemoteReplicaProxy", "ReplicaProcessLauncher", "RemoteFleetRouter",
    "FleetEndpoint", "RemoteWorker", "worker_main", "kernel_launches",
]

# ------------------------------------------------------------ wire frames
#
#   magic(4) | <B version | <I header_len | header JSON | <I header_crc
#           | <Q body_len | <I body_crc | body
#
# The header is {"k": kind, "m": meta}; the body is an opaque payload (KV
# page frames ride there). Every length claim is checked against the
# bytes received before it is trusted, the CRCs cover header and body
# apart, and trailing bytes are an error (a frame is one whole datagram
# on the broker, never a stream prefix).

RPC_MAGIC = b"DRPC"
RPC_VERSION = 1
_RPC_FIXED = struct.Struct("<BI")        # version, header_len
_RPC_BODY = struct.Struct("<QI")         # body_len, body_crc
_CRC = struct.Struct("<I")
#: ceiling of the JSON header: prompts and token lists live there, bulk
#: KV bytes in the body
MAX_RPC_HEADER = 8 * 1024 * 1024


class RpcFrameError(ValueError):
    """A malformed RPC frame (truncated, bit-flipped, hostile length
    prefix, bad magic / version / JSON). Pump threads catch it, count it
    and keep serving."""


class RemoteReplicaError(RuntimeError):
    """A remote worker failed a request with an exception type this
    process does not rebuild."""


def encode_rpc(kind: str, meta: Dict[str, Any], body: bytes = b"") -> bytes:
    header = json.dumps({"k": str(kind), "m": meta},
                        separators=(",", ":")).encode("utf-8")
    if len(header) > MAX_RPC_HEADER:
        raise ValueError(f"rpc header {len(header)}B exceeds "
                         f"{MAX_RPC_HEADER}B — move bulk data to the body")
    return b"".join([
        RPC_MAGIC, _RPC_FIXED.pack(RPC_VERSION, len(header)), header,
        _CRC.pack(zlib.crc32(header) & 0xFFFFFFFF),
        _RPC_BODY.pack(len(body), zlib.crc32(body) & 0xFFFFFFFF), body,
    ])


def decode_rpc(data: bytes) -> Tuple[str, Dict[str, Any], bytes]:
    """Parse and validate one RPC frame: ``(kind, meta, body)``, or
    :class:`RpcFrameError`. Every claim is checked against ``len(data)``
    before use."""
    data = bytes(data)
    n = len(data)
    base = len(RPC_MAGIC) + _RPC_FIXED.size
    if n < base:
        raise RpcFrameError(f"short frame: {n}B < {base}B fixed prologue")
    if data[:4] != RPC_MAGIC:
        raise RpcFrameError(f"bad magic {data[:4]!r}")
    version, header_len = _RPC_FIXED.unpack_from(data, 4)
    if version != RPC_VERSION:
        raise RpcFrameError(f"unsupported rpc version {version}")
    if header_len > MAX_RPC_HEADER:
        raise RpcFrameError(f"hostile header length: claims "
                            f"{header_len}B > {MAX_RPC_HEADER}B ceiling")
    end_header = base + header_len + _CRC.size
    if end_header + _RPC_BODY.size > n:
        raise RpcFrameError(f"hostile header length: claims "
                            f"{header_len}B, frame holds {n}B")
    header = data[base:base + header_len]
    (hcrc,) = _CRC.unpack_from(data, base + header_len)
    if (zlib.crc32(header) & 0xFFFFFFFF) != hcrc:
        raise RpcFrameError("header crc mismatch (bit flip in transit)")
    body_len, bcrc = _RPC_BODY.unpack_from(data, end_header)
    body_off = end_header + _RPC_BODY.size
    if body_len != n - body_off:
        raise RpcFrameError(f"hostile body length: claims {body_len}B, "
                            f"frame holds {n - body_off}B")
    body = data[body_off:]
    if (zlib.crc32(body) & 0xFFFFFFFF) != bcrc:
        raise RpcFrameError("body crc mismatch (bit flip in transit)")
    try:
        doc = json.loads(header.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise RpcFrameError(f"header is not valid JSON: {e}")
    if not isinstance(doc, dict) or not isinstance(doc.get("k"), str) \
            or not isinstance(doc.get("m"), dict):
        raise RpcFrameError("header must be {'k': str, 'm': dict}")
    return doc["k"], doc["m"], body


def _rebuild_error(doc: Dict[str, Any]) -> BaseException:
    """A worker-side failure rebuilt so the router's SLO and burn-rate
    accounting classify it as an in-process engine's would
    (NumericalFault drives the quarantine; DeadlineExceeded, Cancelled and
    RejectedError the SLO outcome classes)."""
    t = str(doc.get("type", "")) if isinstance(doc, dict) else ""
    msg = str(doc.get("msg", "")) if isinstance(doc, dict) else ""
    if t == "NumericalFault":
        from ..observability.integrity import NumericalFault
        return NumericalFault(msg)
    if t == "DeadlineExceeded":
        return DeadlineExceeded(msg)
    if t == "Cancelled":
        return Cancelled(msg)
    if t == "RejectedError":
        return RejectedError(msg)
    return RemoteReplicaError(f"{t or 'RemoteFailure'}: {msg}")


# ----------------------------------------------------- coordinator KV
def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return bytes(buf)


_KV_LEN = struct.Struct("<Q")
MAX_KV_MESSAGE = 64 * 1024 * 1024


def _kv_send(sock: socket.socket, frame: bytes) -> None:
    sock.sendall(_KV_LEN.pack(len(frame)) + frame)


def _kv_recv(sock: socket.socket) -> bytes:
    (n,) = _KV_LEN.unpack(_recv_exact(sock, _KV_LEN.size))
    if n > MAX_KV_MESSAGE:
        raise ConnectionError(f"kv message claims {n}B > "
                              f"{MAX_KV_MESSAGE}B ceiling")
    return _recv_exact(sock, n)


def _close_quietly(sock: socket.socket) -> None:
    try:
        sock.close()
    except OSError:
        pass


class CoordinatorKVServer:
    """Write-once KV store over TCP with the coordinator client surface:
    :class:`~.fleet.KVFleetMembership` beats into it from worker processes
    and the router's monitor scans it, both through
    :class:`CoordinatorKVClient`. One thread per connection; requests and
    responses are length-prefixed RPC frames."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._listener = socket.create_server((host, port))
        self.host, self.port = self._listener.getsockname()[:2]
        self._store: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self.frame_errors = 0
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="kvsrv-accept")
        self._accept.start()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns.append(conn)
                t = threading.Thread(target=self._serve, args=(conn,),
                                     daemon=True,
                                     name=f"kvsrv-conn{len(self._conns)}")
                self._threads.append(t)
            t.start()

    def _handle(self, kind: str, meta: Dict[str, Any]) -> bytes:
        if kind == "kv_set":
            key, value = str(meta.get("key")), str(meta.get("value"))
            with self._lock:
                if key in self._store:
                    return encode_rpc("err", {"error": "exists",
                                              "key": key})
                self._store[key] = value
            return encode_rpc("ok", {})
        if kind == "kv_dir":
            prefix = str(meta.get("prefix", ""))
            with self._lock:
                entries = sorted((k, v) for k, v in self._store.items()
                                 if k.startswith(prefix))
            return encode_rpc("ok", {"entries": entries})
        if kind == "kv_del":
            with self._lock:
                self._store.pop(str(meta.get("key")), None)
            return encode_rpc("ok", {})
        return encode_rpc("err", {"error": f"unknown op {kind!r}"})

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                frame = _kv_recv(conn)
                try:
                    kind, meta, _ = decode_rpc(frame)
                except RpcFrameError as e:
                    with self._lock:
                        self.frame_errors += 1
                    _kv_send(conn, encode_rpc("err", {"error": str(e)}))
                    continue
                _kv_send(conn, self._handle(kind, meta))
        except (OSError, ConnectionError):
            pass
        finally:
            _close_quietly(conn)

    def snapshot(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._store)

    def close(self) -> None:
        self._stop.set()
        _close_quietly(self._listener)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            _close_quietly(c)


class CoordinatorKVClient:
    """Client half of the coordinator KV surface, as
    :class:`~.fleet.KVFleetMembership` expects it: ``key_value_set``
    (write-once: raises on an existing key), ``key_value_dir_get`` and
    ``key_value_delete``. One cached connection, a per-call socket
    timeout and one redial per call; a coordinator that stays
    unreachable surfaces as an exception the membership's retry and
    backoff absorb."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.host, self.port = host, int(port)
        self.timeout = float(timeout)
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._closed = False

    def _checkout(self) -> Optional[socket.socket]:
        # the lock guards only the ownership of the cached connection;
        # socket I/O happens outside it. A concurrent caller that finds
        # the socket checked out dials its own (the server runs a thread
        # per connection)
        with self._lock:
            if self._closed:
                raise ConnectionError("CoordinatorKVClient closed")
            sock, self._sock = self._sock, None
        return sock

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if self._sock is None and not self._closed:
                self._sock = sock
                return
        _close_quietly(sock)

    def _dial(self) -> socket.socket:
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout)
        sock.settimeout(self.timeout)
        return sock

    def _call(self, kind: str, meta: Dict[str, Any]) -> Dict[str, Any]:
        frame = encode_rpc(kind, meta)
        sock = self._checkout()
        try:
            for attempt in (0, 1):       # one redial on a dead socket
                try:
                    if sock is None:
                        sock = self._dial()
                    _kv_send(sock, frame)
                    rk, rm, _ = decode_rpc(_kv_recv(sock))
                    break
                except (OSError, ConnectionError, RpcFrameError):
                    if sock is not None:
                        _close_quietly(sock)
                        sock = None
                    if attempt:
                        raise
        finally:
            if sock is not None:
                self._checkin(sock)
        if rk == "err":
            raise RuntimeError(f"coordinator kv {kind}: {rm.get('error')}")
        return rm

    def key_value_set(self, key: str, value: str) -> None:
        self._call("kv_set", {"key": str(key), "value": str(value)})

    def key_value_dir_get(self, prefix: str) -> List[Tuple[str, str]]:
        entries = self._call("kv_dir", {"prefix": str(prefix)})["entries"]
        return [(str(k), str(v)) for k, v in entries]

    def key_value_delete(self, key: str) -> None:
        self._call("kv_del", {"key": str(key)})

    def close(self) -> None:
        with self._lock:
            self._closed = True
            sock, self._sock = self._sock, None
        if sock is not None:
            _close_quietly(sock)


class RouterSideMembership:
    """The router's view of the shared membership store. Liveness beats
    must come from the worker process itself (a router-side beat for a
    frozen worker would declare a corpse alive), so ``register`` / ``beat``
    do nothing here, while ``ages`` / ``leave`` forward to the store
    (``leave`` writes the retirement tombstone)."""

    def __init__(self, membership: KVFleetMembership):
        self._inner = membership
        self.fleet_id = membership.fleet_id

    def register(self, replica_id: str) -> None:
        pass

    def beat(self, replica_id: str, load: int) -> None:
        pass

    def leave(self, replica_id: str) -> None:
        self._inner.leave(replica_id)

    def ages(self) -> Dict[str, Tuple[float, int]]:
        return self._inner.ages()

    def __getattr__(self, name):
        return getattr(self._inner, name)


# -------------------------------------------------------- replica proxy
def _topic_cmd(fleet_id: str, rid: str) -> str:
    return f"dl4j/rpc/{fleet_id}/{rid}/cmd"


def _topic_evt(fleet_id: str, rid: str) -> str:
    return f"dl4j/rpc/{fleet_id}/{rid}/evt"


class RemoteReplicaProxy:
    """Router-side handle for one worker process, with the bare-engine
    surface :class:`~.fleet.EngineReplica` wraps. Request handles are
    real :class:`~..models.generation.GenerationRequest` objects,
    completed from the worker's result frames, so callbacks,
    ``result()``, traces and SLO records behave as with a local engine.

    Exactly once: the broker delivers a frame at most once, so a retry
    thread re-publishes every dispatch the worker has not ACKed within
    ``ack_timeout`` (the worker dedups by request id). Results are
    fenced three times: worker epoch (a stale incarnation), pending-map
    identity (a migrated-away id) and the router's ledger."""

    def __init__(self, broker, replica_id: str, fleet_id: str, *,
                 num_slots: int = 2, max_pending: int = 256,
                 epoch: int = 0, phase: str = "both",
                 ack_timeout: float = 2.0, retry_interval: float = 0.5,
                 max_dispatch_retries: int = 16,
                 stats_timeout: float = 10.0, registry=None,
                 flight_recorder=None):
        self.replica_id = str(replica_id)
        self.fleet_id = str(fleet_id)
        self.phase = str(phase)
        self._broker = broker
        self._cmd_topic = _topic_cmd(fleet_id, replica_id)
        self._evt_topic = _topic_evt(fleet_id, replica_id)
        # EngineReplica reads these through the bare-engine protocol
        # (dead() takes _lock and checks _shutdown / _dead)
        self._lock = threading.Lock()
        self._shutdown = False
        self._dead: Optional[BaseException] = None
        self.num_slots = int(num_slots)
        self.max_pending = int(max_pending)
        self.epoch = int(epoch)          # the expected worker incarnation
        self.ack_timeout = float(ack_timeout)
        self.retry_interval = float(retry_interval)
        self.max_dispatch_retries = int(max_dispatch_retries)
        self.stats_timeout = float(stats_timeout)
        # id -> [GenerationRequest, acked, last publish t, retries, frame]
        self._pending: Dict[str, List] = {}
        self._stats: Dict[str, Any] = {"queue_depth": 0,
                                       "active_slots": 0}
        self._stats_t = 0.0
        self.hello = threading.Event()
        self.drained = threading.Event()
        self.drain_report: Optional[Dict[str, Any]] = None
        self._audit_delta: Dict[str, Any] = {}
        self._audit_evt = threading.Event()
        self._pong = threading.Event()
        self.counters = {"fenced_results": 0, "stale_epoch": 0,
                         "frame_errors": 0, "dispatch_retries": 0,
                         "results": 0, "acks": 0}
        self.role_meta: Dict[str, Any] = {}
        # router callbacks (RemoteFleetRouter wires them)
        self.on_handoff = None           # (src_rid, meta, body)
        self.on_adopt_failed = None      # (dst_rid, meta)
        self.on_hello = None             # (rid, meta)
        # set by the fleet's _wire_crash_hook on bare engines
        self._supervised = False
        self._on_crash = None
        self._flightrec = flight_recorder if flight_recorder is not None \
            else default_flight_recorder()
        self._stop = threading.Event()
        self._queue = broker.subscribe(self._evt_topic)
        self._pump = threading.Thread(target=self._pump_loop, daemon=True,
                                      name=f"rproxy-{replica_id}-pump")
        self._retry = threading.Thread(target=self._retry_loop,
                                       daemon=True,
                                       name=f"rproxy-{replica_id}-retry")
        self._started = False

    # ------------------------------------------------------- lifecycle
    def start(self) -> "RemoteReplicaProxy":
        with self._lock:
            if self._started:
                return self
            self._started = True
        self._pump.start()
        self._retry.start()
        return self

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            pending = [row[0] for row in self._pending.values()]
            self._pending.clear()
        self._stop.set()
        try:
            self._broker.unsubscribe(self._evt_topic, self._queue)
        except Exception:   # noqa: BLE001 — teardown must not abort
            pass
        exc = RuntimeError(f"remote replica {self.replica_id} shut down")
        for req in pending:
            if not req.done():
                req._fail(exc)

    def notify_crash(self, exc: BaseException) -> None:
        """The launcher saw the process die: mark it dead and raise the
        fleet's crash hook, so the router migrates now instead of
        waiting for the beats to age out."""
        with self._lock:
            if self._dead is not None:
                return
            self._dead = exc
            cb = self._on_crash
        self._flightrec.record("remote_crash", replica=self.replica_id,
                               error=str(exc))
        if cb is not None:
            cb(self, exc)

    def quarantine(self):
        """Migration harvest. The router re-dispatches this proxy's
        in-flight handles on survivors (the same objects, ``requeue``),
        so pending is cleared, not failed: a late result for a cleared id
        is unsolicited and counted fenced."""
        with self._lock:
            if self._dead is None:
                self._dead = RuntimeError(
                    f"remote replica {self.replica_id} quarantined")
            cause = self._dead
            self._pending.clear()
        return [], cause

    def disown(self, request_id: str) -> None:
        """Drop a pending handle without failing it: the KV handoff moved
        its ownership to a decode worker's proxy."""
        with self._lock:
            self._pending.pop(str(request_id), None)

    # --------------------------------------------------------- serving
    def _check_alive(self) -> None:
        with self._lock:
            dead, down = self._dead, self._shutdown
        if down:
            raise RuntimeError(f"remote replica {self.replica_id} "
                               "shut down")
        if dead is not None:
            raise dead

    @staticmethod
    def _remaining(req) -> Optional[float]:
        # the handle's deadline is on this process's interval clock; the
        # wire carries the seconds left and the worker re-anchors them on
        # its own clock (process clocks are never compared)
        if req._deadline_t is None:
            return None
        return max(0.0, float(req._deadline_t) - interval_now())

    def _dispatch_meta(self, req, request_id: str) -> Dict[str, Any]:
        return {
            "id": request_id, "prompt": [int(t) for t in req.prompt],
            "max_new": int(req.max_new_tokens),
            "temperature": float(req.temperature),
            "eos": None if req.eos_id is None else int(req.eos_id),
            "timeout": self._remaining(req),
            "gen": [int(t) for t in req.generated],
        }

    def _track_and_publish(self, request_id: str, req,
                           frame: bytes) -> None:
        with self._lock:
            self._pending[request_id] = [req, False, time.monotonic(),
                                         0, frame]
        # publish outside the lock: broker I/O can block on its deadline
        self._broker.publish(self._cmd_topic, frame)

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               eos_id: Optional[int] = None,
               deadline: Optional[float] = None,
               route: Optional[str] = None,
               journal_id: Optional[str] = None, **_ignored):
        self._check_alive()
        from ..models.generation import GenerationRequest
        req = GenerationRequest(prompt, max_new_tokens, temperature,
                                eos_id, deadline=deadline)
        request_id = str(journal_id) if journal_id is not None \
            else f"{self.replica_id}-{id(req):x}"
        req.journal_id = request_id
        meta = self._dispatch_meta(req, request_id)
        if route is not None:
            meta["route"] = str(route)
        self._track_and_publish(request_id, req,
                                encode_rpc("dispatch", meta))
        return req

    def requeue(self, req) -> None:
        """Migration or failed-handoff re-entry: re-dispatch the same
        handle with its generated prefix; the worker re-prefills prompt +
        prefix and decodes on, token-identical under greedy selection."""
        self._check_alive()
        request_id = str(req.journal_id)
        meta = self._dispatch_meta(req, request_id)
        meta["resume"] = True
        self._track_and_publish(request_id, req,
                                encode_rpc("dispatch", meta))

    def adopt(self, req, kv, meta: Optional[Dict[str, Any]] = None) -> None:
        """KV-handoff receive: forward the serialized page frames to the
        decode worker, whose intake checks the frame CRCs and content
        checksums (``PageFrameSet.from_bytes``)."""
        self._check_alive()
        body = kv if isinstance(kv, (bytes, bytearray)) \
            else kv.to_bytes()
        request_id = str(req.journal_id)
        if meta and "gen" in meta:
            # the prefill worker's generated tokens: the router-side
            # handle never streams mid-flight tokens, so the handoff's
            # meta is what the decode intake's geometry check needs
            req.generated = [int(t) for t in meta["gen"]]
        m = self._dispatch_meta(req, request_id)
        if meta:
            m.update({k: meta[k] for k in ("n_pages", "nbytes",
                                           "tok_bytes") if k in meta})
        self._track_and_publish(request_id, req,
                                encode_rpc("adopt", m, bytes(body)))

    def cancel(self, request_id: str) -> None:
        self._broker.publish(self._cmd_topic,
                             encode_rpc("cancel", {"id": str(request_id)}))

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            dead, down = self._dead, self._shutdown
            snap = dict(self._stats)
            inflight = len(self._pending)
        if down or dead is not None:
            raise RuntimeError(f"remote replica {self.replica_id} "
                               "unreachable")
        # the pushed snapshot lags a heartbeat, while this proxy knows
        # what it dispatched and has not seen complete. Without the floor
        # a submit burst reads every worker at its pre-burst load and the
        # least-loaded order convoys the whole wave onto one process
        active = int(snap.get("active_slots", 0) or 0)
        if inflight > int(snap.get("queue_depth", 0) or 0) + active:
            snap["queue_depth"] = inflight - active
        return snap

    def last_stats(self) -> Dict[str, Any]:
        """The worker's last pushed stats, also after it died."""
        with self._lock:
            return dict(self._stats)

    def refresh_stats(self, timeout: float = 5.0) -> Dict[str, Any]:
        """Stats round trip: publish a stats command and wait for the
        worker's push."""
        before = self._stats_t
        self._broker.publish(self._cmd_topic, encode_rpc("stats", {}))
        end = time.monotonic() + float(timeout)
        while time.monotonic() < end:
            if self._stats_t > before:
                return self.stats()
            time.sleep(0.02)
        raise TimeoutError(f"stats rpc to {self.replica_id} timed out "
                           f"after {timeout}s")

    def audit_delta(self, timeout: float = 10.0) -> Dict[str, Any]:
        """The worker's kernel builds and weight casts since its last
        ``audit_mark``: ``{}`` when it built and cast nothing."""
        self._audit_evt.clear()
        self._broker.publish(self._cmd_topic, encode_rpc("audit_delta", {}))
        if not self._audit_evt.wait(timeout):
            raise TimeoutError(f"audit rpc to {self.replica_id} timed out")
        return dict(self._audit_delta)

    def audit_mark(self) -> None:
        self._broker.publish(self._cmd_topic, encode_rpc("audit_mark", {}))

    def ping(self, timeout: float = 5.0) -> bool:
        self._pong.clear()
        self._broker.publish(self._cmd_topic, encode_rpc("ping", {}))
        return self._pong.wait(timeout)

    # ------------------------------------------------------------ pump
    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            try:
                payload = self._queue.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                kind, meta, body = decode_rpc(payload)
            except RpcFrameError:
                with self._lock:
                    self.counters["frame_errors"] += 1
                continue
            try:
                self._handle_evt(kind, meta, body)
            except Exception as e:   # noqa: BLE001 — a handler bug must
                # not kill the pump; it is recorded instead
                self._flightrec.record("remote_pump_error",
                                       replica=self.replica_id,
                                       kind=kind, error=str(e))

    def _handle_evt(self, kind: str, meta: Dict[str, Any],
                    body: bytes) -> None:
        epoch = int(meta.get("epoch", -1))
        if kind == "hello":
            with self._lock:
                if epoch >= self.epoch:
                    self.epoch = epoch
                    self.num_slots = int(meta.get("num_slots",
                                                  self.num_slots))
                    self.max_pending = int(meta.get("max_pending",
                                                    self.max_pending))
                    self.role_meta = dict(meta)
            self.hello.set()
            cb = self.on_hello
            if cb is not None:
                cb(self.replica_id, meta)
            return
        if epoch < self.epoch:
            # a frame from an earlier incarnation of this worker: the
            # zombie fence (arm 1)
            with self._lock:
                self.counters["stale_epoch"] += 1
            return
        if kind == "ack":
            with self._lock:
                row = self._pending.get(str(meta.get("id")))
                if row is not None:
                    row[1] = True
                self.counters["acks"] += 1
            return
        if kind == "result":
            self._on_result(meta)
            return
        if kind == "stats":
            with self._lock:
                st = meta.get("stats")
                if isinstance(st, dict):
                    self._stats = st
                self._stats_t = time.monotonic()
            return
        if kind == "handoff":
            cb = self.on_handoff
            if cb is not None:
                cb(self.replica_id, meta, body)
            return
        if kind == "adopt_failed":
            cb = self.on_adopt_failed
            if cb is not None:
                cb(self.replica_id, meta)
            return
        if kind == "drained":
            self.drain_report = dict(meta)
            self.drained.set()
            return
        if kind == "audit":
            with self._lock:
                self._audit_delta = dict(meta.get("delta") or {})
            self._audit_evt.set()
            return
        if kind == "pong":
            self._pong.set()
            return
        self._flightrec.record("remote_evt_unknown",
                               replica=self.replica_id, kind=kind)

    def _on_result(self, meta: Dict[str, Any]) -> None:
        request_id = str(meta.get("id"))
        with self._lock:
            row = self._pending.pop(request_id, None)
            if row is None:
                # unsolicited: migrated away, handed off or already done —
                # fence arm 2 (the ledger is arm 3)
                self.counters["fenced_results"] += 1
                return
            self.counters["results"] += 1
        req = row[0]
        if meta.get("ok"):
            gen = meta.get("gen") or []
            req.generated = [int(t) for t in gen]
            if not req.done():
                req._complete()
        else:
            exc = _rebuild_error(meta.get("error") or {})
            if not req.done():
                req._fail(exc)

    def _retry_loop(self) -> None:
        """Dispatch retry keyed by request id: every dispatch / adopt the
        worker has not ACKed is re-published until the worker answers,
        dies, or the retry budget runs out (then the handle fails and the
        router's migration takes over)."""
        while not self._stop.wait(self.retry_interval):
            with self._lock:
                if self._dead is not None or self._shutdown:
                    continue
                now = time.monotonic()
                due = [(rid_, row) for rid_, row in self._pending.items()
                       if not row[1] and now - row[2] >= self.ack_timeout]
                over = []
                frames = []
                for rid_, row in due:
                    if row[3] >= self.max_dispatch_retries:
                        over.append((rid_, row))
                        continue
                    row[2] = now
                    row[3] += 1
                    self.counters["dispatch_retries"] += 1
                    frames.append(row[4])
                for rid_, _ in over:
                    self._pending.pop(rid_, None)
            for rid_, row in over:
                req = row[0]
                if not req.done():
                    req._fail(RemoteReplicaError(
                        f"dispatch {rid_} to {self.replica_id}: no ack "
                        f"after {self.max_dispatch_retries} retries"))
            for frame in frames:
                try:
                    self._broker.publish(self._cmd_topic, frame)
                except Exception:   # noqa: BLE001 — broker outage: the
                    break           # next tick retries


# ---------------------------------------------------- process launcher
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _terminate(proc) -> None:
    """SIGTERM a running child; a stopped one takes it only once it runs
    again, so SIGCONT goes first."""
    if proc.poll() is None:
        try:
            os.kill(proc.pid, signal.SIGCONT)
            proc.terminate()
        except ProcessLookupError:
            pass


class ReplicaProcessLauncher:
    """Spawns each replica as its own OS process and supervises it.

    The config crosses as a JSON file named on the command line (the
    environment carries only pacing knobs); every replica has its own
    journal directory under ``workdir/<rid>/``. A worker serves on the
    CUDA card unless ``device`` is ``"cpu"``: nothing here hides the card
    from a child. An exit the launcher did not ask for restarts the
    worker with exponential backoff, up to ``max_restarts`` a replica;
    ``drain_stop`` sends SIGTERM, so the worker's ``PreemptionHandler``
    drains and journals before it exits, and SIGKILL after the budget.
    ``pause`` / ``resume`` (SIGSTOP / SIGCONT) freeze a process into a
    partitioned zombie for chaos rounds. Each worker's output goes to
    ``workdir/<rid>/worker-<epoch>.log``."""

    def __init__(self, workdir: str, *, broker_addr: Tuple[str, int],
                 kv_addr: Tuple[str, int], fleet_id: str,
                 model: Dict[str, Any],
                 engine: Optional[Dict[str, Any]] = None,
                 device: Optional[str] = None,
                 max_restarts: int = 3, backoff_base: float = 0.25,
                 backoff_cap: float = 4.0, drain_budget: float = 8.0,
                 env: Optional[Dict[str, str]] = None,
                 python: Optional[str] = None):
        self.workdir = str(workdir)
        self.broker_addr = (str(broker_addr[0]), int(broker_addr[1]))
        self.kv_addr = (str(kv_addr[0]), int(kv_addr[1]))
        self.fleet_id = str(fleet_id)
        self.model = dict(model)
        self.engine = dict(engine or {})
        self.device = None if device is None else str(device)
        self.max_restarts = int(max_restarts)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.drain_budget = float(drain_budget)
        self.extra_env = dict(env or {})
        self.python = python or sys.executable
        self._lock = threading.Lock()
        # rid -> {proc, epoch, role, stopping, restarts, extra}
        self._procs: Dict[str, Dict[str, Any]] = {}
        #: (rid, epoch) -> monotonic time of its spawn
        self.spawn_t: Dict[Tuple[str, int], float] = {}
        self._watchers: List[threading.Thread] = []
        self.on_exit = None    # callable(rid, returncode, will_restart)
        self.on_spawn = None   # callable(rid, epoch, pid)
        self._flightrec = default_flight_recorder()

    # ------------------------------------------------------------ spawn
    def log_path(self, rid: str, epoch: int) -> str:
        return os.path.join(self.workdir, str(rid), f"worker-{epoch}.log")

    def _config(self, rid: str, role: str, epoch: int,
                extra: Optional[Dict[str, Any]]) -> str:
        rdir = os.path.join(self.workdir, rid)
        os.makedirs(rdir, exist_ok=True)
        cfg = {
            "rid": rid, "role": role, "epoch": epoch,
            "fleet_id": self.fleet_id,
            "broker": list(self.broker_addr), "kv": list(self.kv_addr),
            "journal_dir": os.path.join(rdir, "journal"),
            "model": self.model, "engine": dict(self.engine),
            "device": self.device, "drain_budget": self.drain_budget,
        }
        if extra:
            cfg.update(extra)
        path = os.path.join(rdir, "config.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(cfg, f)
        os.replace(tmp, path)
        return path

    def _spawn_locked(self, rid: str, row: Dict[str, Any]) -> None:
        cfg_path = self._config(rid, row["role"], row["epoch"],
                                row.get("extra"))
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + \
            env.get("PYTHONPATH", "")
        env.update(self.extra_env)
        self.spawn_t[(rid, int(row["epoch"]))] = time.monotonic()
        with open(self.log_path(rid, row["epoch"]), "ab") as log:
            row["proc"] = subprocess.Popen(
                [self.python, "-m", "deeplearning4j_tpu_torch.streaming."
                 "remote", cfg_path], env=env, cwd=_REPO_ROOT,
                stdout=log, stderr=subprocess.STDOUT)

    def spawn(self, rid: str, role: str = "both",
              extra: Optional[Dict[str, Any]] = None) -> int:
        """Launch (or relaunch after ``forget``) replica ``rid``; its
        pid."""
        rid = str(rid)
        with self._lock:
            if rid in self._procs and \
                    self._procs[rid]["proc"].poll() is None:
                raise ValueError(f"replica process {rid!r} already "
                                 "running")
            epoch = self._procs.get(rid, {}).get("epoch", 0) + 1
            row = {"proc": None, "epoch": epoch, "role": str(role),
                   "stopping": False, "restarts": 0, "extra": extra}
            self._procs[rid] = row
            self._spawn_locked(rid, row)
            proc = row["proc"]
            t = threading.Thread(target=self._watch, args=(rid,),
                                 daemon=True, name=f"launch-{rid}-watch")
            self._watchers.append(t)
        t.start()
        cb = self.on_spawn
        if cb is not None:
            cb(rid, epoch, proc.pid)
        self._flightrec.record("worker_spawn", replica=rid, epoch=epoch,
                               pid=proc.pid)
        return proc.pid

    def _watch(self, rid: str) -> None:
        while True:
            with self._lock:
                row = self._procs.get(rid)
                proc = None if row is None else row["proc"]
            if proc is None:
                return
            rc = proc.wait()     # blocking, outside every lock
            with self._lock:
                row = self._procs.get(rid)
                if row is None or row["proc"] is not proc:
                    return       # superseded by an explicit respawn
                restart = (not row["stopping"]
                           and row["restarts"] < self.max_restarts)
                if restart:
                    row["restarts"] += 1
                    backoff = min(
                        self.backoff_base * (2 ** (row["restarts"] - 1)),
                        self.backoff_cap)
            self._flightrec.record("worker_exit", replica=rid, rc=rc,
                                   restart=restart)
            cb = self.on_exit
            if cb is not None:
                try:
                    cb(rid, rc, restart)
                except Exception:   # noqa: BLE001 — a callback bug must
                    pass            # not stop supervision
            if not restart:
                return
            time.sleep(backoff)
            with self._lock:
                row = self._procs.get(rid)
                if row is None or row["stopping"]:
                    return
                row["epoch"] += 1
                self._spawn_locked(rid, row)
                proc2, epoch2 = row["proc"], row["epoch"]
            cb = self.on_spawn
            if cb is not None:
                cb(rid, epoch2, proc2.pid)
            self._flightrec.record("worker_respawn", replica=rid,
                                   epoch=epoch2, pid=proc2.pid)

    # ----------------------------------------------------------- signal
    def _proc(self, rid: str):
        with self._lock:
            row = self._procs.get(str(rid))
            return None if row is None else row["proc"]

    def pid(self, rid: str) -> Optional[int]:
        p = self._proc(rid)
        return None if p is None else p.pid

    def pids(self) -> Dict[str, int]:
        with self._lock:
            return {rid: row["proc"].pid
                    for rid, row in self._procs.items()
                    if row["proc"] is not None
                    and row["proc"].poll() is None}

    def epoch(self, rid: str) -> int:
        with self._lock:
            row = self._procs.get(str(rid))
            return 0 if row is None else int(row["epoch"])

    def kill(self, rid: str) -> None:
        """SIGKILL; supervision restarts it (budget permitting)."""
        p = self._proc(rid)
        if p is not None and p.poll() is None:
            p.kill()

    def pause(self, rid: str) -> None:
        """SIGSTOP: beats stop and sockets black-hole; the router sees a
        partition, not a death."""
        p = self._proc(rid)
        if p is not None and p.poll() is None:
            os.kill(p.pid, signal.SIGSTOP)

    def resume(self, rid: str) -> None:
        p = self._proc(rid)
        if p is not None and p.poll() is None:
            os.kill(p.pid, signal.SIGCONT)

    def drain_stop(self, rid: str,
                   budget: Optional[float] = None) -> Optional[int]:
        """SIGTERM drain through the worker's PreemptionHandler, SIGKILL
        after the budget; the exit code (None if it never ran)."""
        budget = self.drain_budget if budget is None else float(budget)
        with self._lock:
            row = self._procs.get(str(rid))
            if row is None:
                return None
            row["stopping"] = True
            proc = row["proc"]
        if proc is None:
            return None
        _terminate(proc)
        try:
            return proc.wait(timeout=budget + 5.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            return proc.wait()

    def forget(self, rid: str) -> None:
        with self._lock:
            self._procs.pop(str(rid), None)

    def stop_all(self, budget: Optional[float] = None) -> None:
        """Drain every worker at once: SIGTERM them all, then wait for
        each (SIGKILL after the budget)."""
        budget = self.drain_budget if budget is None else float(budget)
        with self._lock:
            rows = list(self._procs.values())
            for row in rows:
                row["stopping"] = True
        procs = [row["proc"] for row in rows if row["proc"] is not None]
        for proc in procs:
            _terminate(proc)
        end = time.monotonic() + budget + 5.0
        for proc in procs:
            try:
                proc.wait(timeout=max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


# -------------------------------------------------------- remote router
class RemoteFleetRouter(EngineFleetRouter):
    """:class:`~.fleet.EngineFleetRouter` over
    :class:`RemoteReplicaProxy` replicas, plus the cross-process KV
    handoff of role-split fleets. The base router's ledger, heartbeat
    aging over the shared coordinator store, clone migration and SLO
    gate are inherited unchanged; this class adds the phase-pool dispatch
    policy and the wire handoff (the remote counterpart of
    ``disagg.PhaseRouter``'s, fenced by the same ``try_reassign_from``)."""

    def __init__(self, *, proxies: Dict[str, RemoteReplicaProxy],
                 roles: Optional[Dict[str, str]] = None, **kwargs):
        self._roles = {rid: str(role)
                       for rid, role in (roles or {}).items()}
        kwargs.setdefault("heartbeat_interval", 0.5)
        super().__init__(replicas=[proxies[rid] for rid in proxies],
                         replica_ids=list(proxies), **kwargs)
        self._wire_proxy_hooks(proxies.values())
        reg = kwargs.get("registry") or default_registry()
        labels = (self.fleet_id, "wire")
        self._m_wire = {
            "handoffs": reg.counter(
                "kv_handoffs_total", "cross-process KV handoffs",
                ("fleet", "transport")).labels(*labels),
            "fenced": reg.counter(
                "kv_handoffs_fenced_total",
                "handoffs dropped by the ownership fence",
                ("fleet", "transport")).labels(*labels),
            "reprefills": reg.counter(
                "kv_handoff_reprefills_total",
                "failed handoffs re-prefilled on the prefill pool",
                ("fleet", "transport")).labels(*labels),
            "bytes": reg.counter(
                "kv_transfer_bytes_total",
                "KV payload bytes across the handoff seam",
                ("fleet", "transport")).labels(*labels),
            "wire_bytes": reg.counter(
                "kv_transfer_wire_bytes_total",
                "encoded frame bytes across the wire",
                ("fleet", "transport")).labels(*labels),
            "pages": reg.counter(
                "kv_transfer_pages_total", "KV pages shipped",
                ("fleet", "transport")).labels(*labels),
            "corruption": reg.counter(
                "kv_corruption_total",
                "content-checksum failures at decode intake",
                ("fleet", "transport")).labels(*labels),
        }

    def _wire_proxy_hooks(self, proxies) -> None:
        for proxy in proxies:
            proxy.on_handoff = self._on_wire_handoff
            proxy.on_adopt_failed = self._on_wire_adopt_failed

    # ------------------------------------------------------ phase pools
    def role_ids(self, role: str) -> List[str]:
        return sorted(r for r, ro in self._roles.items() if ro == role)

    def replica_role(self, rid: str) -> Optional[str]:
        return self._roles.get(rid)

    def _dispatch_order(self, prefer=None, sticky_key=None, rids=None):
        # role-split fleet: fresh dispatches and every re-prefill enter
        # through the prefill pool; the decode pool is reached only by
        # the fenced handoff
        if rids is None:
            prefill = self.role_ids(ROLE_PREFILL)
            if prefill:
                rids = prefill
        return super()._dispatch_order(prefer=prefer,
                                       sticky_key=sticky_key, rids=rids)

    def _first_live(self, order):
        for rep in order:
            if not rep.dead():
                return rep
        return None

    # ------------------------------------------------------ wire handoff
    def _on_wire_handoff(self, src_rid: str, meta: Dict[str, Any],
                         body: bytes) -> None:
        """A prefill worker exported and serialized a request's KV pages:
        fence the ownership, move it onto a decode worker, and forward
        the blob unparsed (the decode worker's ``from_bytes`` intake is
        the one validation point)."""
        fid = str(meta.get("id"))
        with self._lock:
            fr = self._live.get(fid)
        if fr is None or fr.done():
            self._m_wire["fenced"].inc()
            return
        with self._migrate_lock:
            with fr._lock:
                stale = fr.done() or fr.replica_id != src_rid
            if stale:
                self._m_wire["fenced"].inc()
                return
            order, _ = self._dispatch_order(
                rids=self.role_ids(ROLE_DECODE))
            dst = self._first_live(order)
            if dst is None:
                exc = RuntimeError(
                    f"fleet {self.fleet_id}: no live decode worker to "
                    "receive the KV handoff")
                with fr._lock:
                    if not fr.done():
                        fr._fail(exc)
                self._ledger.try_complete(fid, src_rid)
                return
            if not self._ledger.try_reassign_from(fid, src_rid,
                                                  dst.replica_id):
                self._m_wire["fenced"].inc()
                return
            with fr._lock:
                fr.replica_id = dst.replica_id
                inner = fr._inner
        # wire and adopt outside the migrate lock (broker I/O)
        src_rep = self._replicas.get(src_rid)
        if src_rep is not None:
            src_rep.engine.disown(fid)
        self._m_wire["handoffs"].inc()
        self._m_wire["bytes"].inc(int(meta.get("nbytes", len(body))))
        self._m_wire["wire_bytes"].inc(len(body))
        self._m_wire["pages"].inc(int(meta.get("n_pages", 0)))
        try:
            dst.engine.adopt(inner, bytes(body), meta)
        except Exception as e:   # noqa: BLE001 — a dead / shut-down dst
            self._reprefill_wire(fid, dst.replica_id, str(e))

    def _on_wire_adopt_failed(self, dst_rid: str,
                              meta: Dict[str, Any]) -> None:
        """The decode intake refused the frames (a corrupt page, a
        geometry mismatch, a dead engine): re-prefill on the prefill pool
        under the same ownership fence."""
        if str(meta.get("kind")) == "corrupt":
            self._m_wire["corruption"].inc()
        self._reprefill_wire(str(meta.get("id")), dst_rid,
                             str(meta.get("error", "adopt failed")))

    def _reprefill_wire(self, fid: str, owner_rid: str,
                        cause: str) -> None:
        with self._lock:
            fr = self._live.get(fid)
        if fr is None or fr.done():
            self._m_wire["fenced"].inc()
            return
        with self._migrate_lock:
            with fr._lock:
                stale = fr.done() or fr.replica_id != owner_rid
            if stale:
                self._m_wire["fenced"].inc()
                return
            order, _ = self._dispatch_order()
            dst = self._first_live(order)
            if dst is None:
                exc = RuntimeError(
                    f"fleet {self.fleet_id}: handoff failed ({cause}) "
                    "and no live prefill worker to re-prefill")
                with fr._lock:
                    if not fr.done():
                        fr._fail(exc)
                self._ledger.try_complete(fid, owner_rid)
                return
            if not self._ledger.try_reassign_from(fid, owner_rid,
                                                  dst.replica_id):
                self._m_wire["fenced"].inc()
                return
            with fr._lock:
                fr.replica_id = dst.replica_id
                inner = fr._inner
        owner = self._replicas.get(owner_rid)
        if owner is not None:
            owner.engine.disown(fid)
        self._m_wire["reprefills"].inc()
        self._flightrec.record("handoff_reprefill", fleet=self.fleet_id,
                               request=fid, cause=cause)
        try:
            dst.engine.requeue(inner)
        except Exception as exc:   # noqa: BLE001 — no survivor path
            with fr._lock:
                if not fr.done():
                    fr._fail(exc)
            self._ledger.try_complete(fid, dst.replica_id)

    def stats(self) -> Dict[str, Any]:
        s = super().stats()
        s["wire_handoffs"] = int(self._m_wire["handoffs"].value)
        s["wire_handoffs_fenced"] = int(self._m_wire["fenced"].value)
        s["wire_handoff_reprefills"] = \
            int(self._m_wire["reprefills"].value)
        s["wire_transfer_bytes"] = int(self._m_wire["bytes"].value)
        s["wire_transfer_wire_bytes"] = \
            int(self._m_wire["wire_bytes"].value)
        s["wire_transfer_pages"] = int(self._m_wire["pages"].value)
        s["wire_kv_corruption"] = int(self._m_wire["corruption"].value)
        return s


# ------------------------------------------------------- front endpoint
class FleetEndpoint:
    """The front tier: N worker processes behind one submit endpoint.

    Owns the broker server, the coordinator KV server, the
    :class:`ReplicaProcessLauncher`, one :class:`RemoteReplicaProxy` a
    worker and a :class:`RemoteFleetRouter` over them. A worker death the
    launcher sees raises the router's crash hook for immediate
    migration; a respawn re-adopts the same replica id with a fresh proxy
    at the new worker epoch. ``scale_up`` / ``retire`` are the
    per-process scaling verbs. ``device`` goes into every worker's config
    (None: the CUDA card). A worker that sends no hello within
    ``hello_deadline`` raises ``TimeoutError`` naming its log."""

    def __init__(self, workdir: str, model: Dict[str, Any], *,
                 workers: Optional[Dict[str, str]] = None,
                 engine: Optional[Dict[str, Any]] = None,
                 device: Optional[str] = None,
                 fleet_id: str = "remote0", hello_deadline: float = 90.0,
                 heartbeat_interval: float = 0.25,
                 monitor_interval: float = 0.25,
                 suspect_after: float = 1.0, dead_after: float = 3.0,
                 max_restarts: int = 3, drain_budget: float = 8.0,
                 env: Optional[Dict[str, str]] = None,
                 registry=None, completed_window: int = 4096):
        self.workdir = str(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.fleet_id = str(fleet_id)
        self.workers = dict(workers or {"w0": "both", "w1": "both"})
        self.hello_deadline = float(hello_deadline)
        self._registry = registry if registry is not None \
            else default_registry()
        self._flightrec = default_flight_recorder()
        self.broker_server = TcpBrokerServer(port=0).start()
        self.kv_server = CoordinatorKVServer(port=0)
        self.launcher = ReplicaProcessLauncher(
            self.workdir,
            broker_addr=(self.broker_server.host, self.broker_server.port),
            kv_addr=(self.kv_server.host, self.kv_server.port),
            fleet_id=self.fleet_id, model=model, engine=engine,
            device=device, max_restarts=max_restarts,
            drain_budget=drain_budget, env=env)
        self.launcher.on_exit = self._on_child_exit
        self.broker = TcpMessageBroker(self.broker_server.host,
                                       self.broker_server.port,
                                       registry=self._registry)
        self._kv_client = CoordinatorKVClient(self.kv_server.host,
                                              self.kv_server.port)
        self._membership = KVFleetMembership(self._kv_client,
                                             fleet_id=self.fleet_id)
        self._proxies: Dict[str, RemoteReplicaProxy] = {}
        # every proxy this endpoint made, replaced ones too: their last
        # stats carry the launches of incarnations that died
        self.all_proxies: List[RemoteReplicaProxy] = []
        #: "rid@epoch" -> seconds from its spawn to its hello
        self.hello_s: Dict[str, float] = {}
        eng = dict(engine or {})
        for rid, role in self.workers.items():
            self._proxies[rid] = self._make_proxy(rid, role, eng)
        roles = {rid: role for rid, role in self.workers.items()
                 if role in (ROLE_PREFILL, ROLE_DECODE)}
        self.router = RemoteFleetRouter(
            proxies=self._proxies, roles=roles or None,
            membership=RouterSideMembership(self._membership),
            fleet_id=self.fleet_id, registry=self._registry,
            monitor_interval=monitor_interval,
            suspect_after=suspect_after, dead_after=dead_after,
            completed_window=completed_window)
        self._lock = threading.Lock()
        self._started = False
        self._closed = False

    def _make_proxy(self, rid: str, role: str,
                    eng: Dict[str, Any]) -> RemoteReplicaProxy:
        proxy = RemoteReplicaProxy(
            self.broker, rid, self.fleet_id,
            num_slots=int(eng.get("num_slots", 2)),
            max_pending=int(eng.get("max_pending", 256)),
            phase=role, registry=self._registry)
        proxy.on_hello = self._on_child_hello
        self.all_proxies.append(proxy)
        return proxy

    # -------------------------------------------------------- lifecycle
    def start(self) -> "FleetEndpoint":
        with self._lock:
            if self._started or self._closed:
                return self
            self._started = True
            # spawned under the lock: a shutdown racing a boot in another
            # thread stops every worker, and none starts after it
            for proxy in self._proxies.values():
                proxy.start()
            for rid, role in self.workers.items():
                self.launcher.spawn(rid, role)
        self.wait_ready(self.hello_deadline)
        self.router.start()
        return self

    def _no_hello(self, rid: str, what: str) -> TimeoutError:
        path = self.launcher.log_path(rid, self.launcher.epoch(rid))
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                tail = f.read()[-4000:]
        except OSError as e:
            tail = f"(unreadable: {e})"
        return TimeoutError(f"{what} {rid} sent no hello within "
                            f"{self.hello_deadline}s; {path}:\n{tail}")

    def wait_ready(self, deadline: float) -> None:
        end = time.monotonic() + float(deadline)
        for rid, proxy in self._proxies.items():
            left = end - time.monotonic()
            if left <= 0 or not proxy.hello.wait(left):
                raise self._no_hello(rid, "worker")

    def submit(self, *args, **kwargs):
        return self.router.submit(*args, **kwargs)

    def stats(self) -> Dict[str, Any]:
        return self.router.stats()

    def fleet_stats(self) -> Dict[str, Any]:
        return self.router.fleet_stats()

    def pids(self) -> Dict[str, int]:
        return self.launcher.pids()

    def proxy(self, rid: str) -> Optional[RemoteReplicaProxy]:
        with self._lock:
            return self._proxies.get(str(rid))

    def shutdown(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self.router.shutdown()
        finally:
            self.launcher.stop_all()
            for proxy in list(self._proxies.values()):
                proxy.shutdown()
            try:
                self.broker.close()
            except Exception:   # noqa: BLE001
                pass
            self._kv_client.close()
            self.broker_server.close()
            self.kv_server.close()

    # ----------------------------------------------- supervision seams
    def _on_child_exit(self, rid: str, rc: int, will_restart: bool) -> None:
        proxy = self.proxy(rid)
        if proxy is None:
            return
        proxy.notify_crash(RemoteReplicaError(
            f"worker {rid} exited rc={rc}"
            f"{' (restarting)' if will_restart else ''}"))

    def _on_child_hello(self, rid: str, meta: Dict[str, Any]) -> None:
        """The first hello is ``wait_ready``'s; a later one at a higher
        epoch is a supervised restart: re-adopt the replica id with a
        fresh proxy, so the fleet serves through the new incarnation."""
        epoch = int(meta.get("epoch", 0))
        t0 = self.launcher.spawn_t.get((rid, epoch))
        with self._lock:
            if t0 is not None:
                self.hello_s.setdefault(f"{rid}@{epoch}",
                                        time.monotonic() - t0)
            if not self._started or self._closed:
                return
            proxy = self._proxies.get(rid)
            if proxy is None or proxy._dead is None \
                    or epoch <= proxy.epoch - 1:
                return
        self._readopt(rid, epoch, meta)

    def _readopt(self, rid: str, epoch: int, meta: Dict[str, Any]) -> None:
        old = self.proxy(rid)
        role = self.workers.get(rid, "both")
        fresh = self._make_proxy(rid, role,
                                 dict(self.launcher.engine)).start()
        fresh.epoch = epoch
        fresh.role_meta = dict(meta)
        fresh.hello.set()
        with self._lock:
            self._proxies[rid] = fresh
        # the fleet supports explicit id reuse (add_replica sheds the
        # id's dead history); drop the corpse's row first
        with self.router._lock:
            self.router._replicas.pop(rid, None)
            self.router._health.pop(rid, None)
        self.router._wire_proxy_hooks([fresh])
        try:
            self.router.add_replica(engine=fresh, replica_id=rid)
        except Exception as e:   # noqa: BLE001 — shutdown race
            self._flightrec.record("readopt_failed", replica=rid,
                                   error=str(e))
            return
        if old is not None:
            old.shutdown()
        self._flightrec.record("worker_readopt", replica=rid,
                               epoch=epoch)

    # ------------------------------------------------------ autoscaling
    def scale_up(self, role: str = "both",
                 rid: Optional[str] = None) -> str:
        """Launch a new worker process and add it to the fleet once its
        hello arrives."""
        with self._lock:
            if rid is None:
                n = 0
                while f"w{n}" in self._proxies:
                    n += 1
                rid = f"w{n}"
            if rid in self._proxies:
                raise ValueError(f"worker id {rid!r} already exists")
            self.workers[rid] = str(role)
            proxy = self._make_proxy(rid, role,
                                     dict(self.launcher.engine))
            self._proxies[rid] = proxy
        proxy.start()
        self.launcher.spawn(rid, role)
        if not proxy.hello.wait(self.hello_deadline):
            raise self._no_hello(rid, "scaled-up worker")
        if role in (ROLE_PREFILL, ROLE_DECODE):
            self.router._roles[rid] = str(role)
        self.router.add_replica(engine=proxy, replica_id=rid)
        return rid

    def retire(self, rid: str, budget: Optional[float] = None) -> None:
        """Per-process scale-down: migrate the worker's streams to the
        survivors, SIGTERM-drain the process (its PreemptionHandler
        journals whatever raced in) and forget it."""
        self.router.kill_replica(rid, mode="crash")
        self.launcher.drain_stop(rid, budget)
        self.launcher.forget(rid)
        with self._lock:
            self.workers.pop(rid, None)
            proxy = self._proxies.pop(rid, None)
        if proxy is not None:
            proxy.shutdown()

    # --------------------------------------------------------- chaos ops
    def kill_worker(self, rid: str) -> None:
        self.launcher.kill(rid)

    def partition_worker(self, rid: str) -> None:
        self.launcher.pause(rid)

    def heal_worker(self, rid: str) -> None:
        self.launcher.resume(rid)


# ------------------------------------------------------- worker process
def kernel_launches() -> Dict[str, int]:
    """This process's kernel launches by wrapper, under the names
    ``chip_smoke.read_launches`` gives them (a kernel with a backward
    wrapper also as ``<name>.bwd``)."""
    from ..kernels import batchnorm, lstm
    from ..kernels.flash_backward import flash_backward_dkv, flash_backward_dq
    from ..kernels.flash_forward import flash_forward
    from ..kernels.shortseq_attention import (short_attention_bwd,
                                              short_attention_fwd)
    return {
        "shortseq_attention": int(short_attention_fwd.launches),
        "flash_forward": int(flash_forward.launches),
        "shortseq_attention_bwd": int(short_attention_bwd.launches),
        "flash_backward_dq": int(flash_backward_dq.launches),
        "flash_backward_dkv": int(flash_backward_dkv.launches),
        "lstm_recurrence": int(lstm.lstm_recurrence_fwd.launches),
        "batchnorm_train": int(batchnorm.bn_train_fwd.launches),
        "batchnorm_train.bwd": int(batchnorm.bn_train_bwd.launches),
        "batchnorm_add_act_train": int(batchnorm.bn_add_act_fwd.launches),
        "batchnorm_add_act_train.bwd":
            int(batchnorm.bn_add_act_bwd.launches),
    }


def params_digest(net) -> str:
    """A digest of the net's weights: blake2b over each parameter's name,
    shape and position-weighted sum of its raw words, the sum computed
    where the tensor lives (int64 arithmetic wraps and adds exactly in
    any order, so equal bits give equal digests in any process on any
    device, while a word that differs moves its term). On the card it
    reads back one number a parameter, not the weights."""
    import torch
    words_of = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    h = hashlib.blake2b(digest_size=16)
    for vertex in net.conf.topological_order:
        for key in sorted(net.params.get(vertex, {})):
            t = net.params[vertex][key].detach().contiguous().view(-1)
            words = t.view(words_of[t.element_size()]).to(torch.int64)
            weights = torch.arange(1, 2 * words.numel(), 2,
                                   dtype=torch.int64, device=t.device)
            total = int((words * weights).sum())
            h.update(f"{vertex}/{key}/{tuple(t.shape)}/{total};".encode())
    return h.hexdigest()


class RemoteWorker:
    """The replica process: one journaled
    :class:`~..models.generation.SlotGenerationEngine` served over the
    broker. Dedup (the exactly-once half the worker owns): an id in
    flight is ACKed and ignored; a completed id re-publishes the cached
    result (the router fences the duplicate); a handed-off id is ACKed
    as ``handed`` and never served here again. SIGTERM drains through
    :class:`~..parallel.preemption.PreemptionHandler` (journal +
    requeue), then a ``drained`` event goes out and the worker leaves the
    membership. Beats go to the coordinator store from this process."""

    DONE_CACHE = 4096

    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = cfg
        self.rid = str(cfg["rid"])
        self.role = str(cfg.get("role", "both"))
        self.epoch = int(cfg.get("epoch", 1))
        self.fleet_id = str(cfg.get("fleet_id", "remote0"))
        self._evt_topic = _topic_evt(self.fleet_id, self.rid)
        self._cmd_topic = _topic_cmd(self.fleet_id, self.rid)
        self._lock = threading.Lock()
        self._inflight: Dict[str, Any] = {}
        self._done: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._handed: set = set()
        self.frame_errors = 0
        self._stop = threading.Event()
        self._broker: Optional[TcpMessageBroker] = None
        self._engine = None
        self._decoder = None
        self._audit_snap: Optional[Tuple[int, int]] = None
        self._membership: Optional[KVFleetMembership] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._transport = None

    # ------------------------------------------------------------- wire
    def _publish(self, kind: str, meta: Dict[str, Any],
                 body: bytes = b"") -> None:
        meta = dict(meta)
        meta["epoch"] = self.epoch
        try:
            self._broker.publish(self._evt_topic,
                                 encode_rpc(kind, meta, body))
        except Exception:   # noqa: BLE001 — broker outage: frames are at
            pass            # most once; the router's retry asks again

    def _emit_result(self, request_id: str, req) -> None:
        with self._lock:
            if request_id in self._done or request_id in self._handed:
                return
        if req._error is not None:
            meta = {"id": request_id, "ok": False, "src": "live",
                    "error": {"type": type(req._error).__name__,
                              "msg": str(req._error)}}
        else:
            meta = {"id": request_id, "ok": True, "src": "live",
                    "gen": [int(t) for t in req.generated]}
        self._remember(request_id, meta)
        self._publish("result", meta)

    def _remember(self, request_id: str, meta: Dict[str, Any]) -> None:
        with self._lock:
            self._inflight.pop(request_id, None)
            self._done[request_id] = meta
            while len(self._done) > self.DONE_CACHE:
                self._done.popitem(last=False)

    def _track(self, request_id: str, req) -> None:
        with self._lock:
            self._inflight[request_id] = req
        req.add_done_callback(
            lambda r, rid_=request_id: self._emit_result(rid_, r))

    # ---------------------------------------------------------- serving
    def _build_request(self, meta: Dict[str, Any]):
        import numpy as np

        from ..models.generation import GenerationRequest
        timeout = meta.get("timeout")
        # GenerationRequest takes a relative deadline and anchors it on
        # this process's interval clock
        req = GenerationRequest(
            np.asarray(meta["prompt"], dtype=np.int32),
            int(meta["max_new"]), float(meta.get("temperature", 0.0)),
            None if meta.get("eos") is None else int(meta["eos"]),
            deadline=None if timeout is None else float(timeout))
        req.journal_id = str(meta["id"])
        req.generated = [int(t) for t in meta.get("gen") or []]
        return req

    def _dedup(self, request_id: str) -> Optional[str]:
        with self._lock:
            if request_id in self._done:
                return "done"
            if request_id in self._inflight:
                return "inflight"
            if request_id in self._handed:
                return "handed"
        return None

    def _replay_done(self, request_id: str) -> None:
        with self._lock:
            cached = self._done.get(request_id)
        if cached is not None:
            self._publish("result", cached)

    def _handle_dispatch(self, meta: Dict[str, Any]) -> None:
        request_id = str(meta["id"])
        state = self._dedup(request_id)
        if state == "handed" and meta.get("resume"):
            # the router is authoritative for re-prefills: a failed
            # handoff comes back here under the ownership fence. A
            # duplicated non-resume frame for a handed-off id stays fenced
            with self._lock:
                self._handed.discard(request_id)
            state = None
        self._publish("ack", {"id": request_id,
                              "dedup": state or "fresh"})
        if state == "done":
            self._replay_done(request_id)
            return
        if state is not None:
            return
        req = self._build_request(meta)
        if req.generated or meta.get("resume"):
            self._track(request_id, req)
            self._engine.requeue(req)
        else:
            # submit() builds its own handle; track that one
            inner = self._engine.submit(
                req.prompt, req.max_new_tokens,
                temperature=req.temperature, eos_id=req.eos_id,
                deadline=req.deadline, journal_id=request_id,
                _slo_sync_fail=False)
            self._track(request_id, inner)

    def _handle_adopt(self, meta: Dict[str, Any], body: bytes) -> None:
        request_id = str(meta["id"])
        state = self._dedup(request_id)
        self._publish("ack", {"id": request_id,
                              "dedup": state or "fresh"})
        if state == "done":
            self._replay_done(request_id)
            return
        if state is not None:
            return
        from ..models.paging import PageCorruptionError, PageFrameSet
        try:
            # intake: frame CRCs and content checksums
            frames = PageFrameSet.from_bytes(body)
        except PageCorruptionError as e:
            self._publish("adopt_failed", {"id": request_id,
                                           "kind": "corrupt",
                                           "error": str(e)})
            return
        except ValueError as e:
            self._publish("adopt_failed", {"id": request_id,
                                           "kind": "frame",
                                           "error": str(e)})
            return
        req = self._build_request(meta)
        try:
            self._track(request_id, req)
            self._engine.adopt(req, frames)
        except ValueError as e:
            with self._lock:
                self._inflight.pop(request_id, None)
            self._publish("adopt_failed", {"id": request_id,
                                           "kind": "geometry",
                                           "error": str(e)})

    def _builds(self) -> Tuple[int, int]:
        from ..kernels import cuda_lib
        return cuda_lib.nvcc_runs(), int(self._decoder.param_casts)

    def _handle_cmd(self, kind: str, meta: Dict[str, Any],
                    body: bytes) -> None:
        if kind == "dispatch":
            self._handle_dispatch(meta)
        elif kind == "adopt":
            self._handle_adopt(meta, body)
        elif kind == "cancel":
            with self._lock:
                req = self._inflight.get(str(meta.get("id")))
            if req is not None:
                req.cancel()
        elif kind == "stats":
            self._push_stats()
        elif kind == "audit_mark":
            self._audit_snap = self._builds()
        elif kind == "audit_delta":
            delta = {}
            if self._audit_snap is not None:
                now = self._builds()
                for key, a, b in zip(("nvcc_runs", "param_casts"),
                                     self._audit_snap, now):
                    if b != a:
                        delta[key] = b - a
            self._publish("audit", {"delta": delta})
        elif kind == "ping":
            self._publish("pong", {})
        elif kind == "stop":
            self._stop.set()

    def _handoff_sink(self, req, state) -> None:
        """The prefill engine's handoff callback (serve thread): serialize
        the page frames with the SerializedKVTransport encoding and
        publish them; the decode worker's intake is the other half of the
        round trip the in-process transport makes locally."""
        request_id = str(req.journal_id)
        blob = state.to_bytes()
        if self._transport is not None:
            # the exact-transfer account: one (pages, payload, token
            # bytes) row a ship, as the in-process tier keeps it
            self._transport.ships.append(
                (state.n_pages, state.nbytes, int(state.tokens.nbytes)))
            self._transport.wire_frames += 1
            self._transport.wire_bytes += len(blob)
            self._transport.shipped += 1
        with self._lock:
            self._inflight.pop(request_id, None)
            self._handed.add(request_id)
        self._publish("handoff", {
            "id": request_id, "src": self.rid,
            # the generated tokens ride the handoff: the decode intake's
            # geometry check wants frames covering prompt + generated - 1
            "gen": [int(t) for t in req.generated],
            "n_pages": int(state.n_pages), "nbytes": int(state.nbytes),
            "tok_bytes": int(state.tokens.nbytes)}, blob)

    # -------------------------------------------------------- lifecycle
    def _build_account(self) -> Dict[str, Any]:
        nvcc, casts = self._builds()
        return {"pid": os.getpid(), "epoch": self.epoch,
                "nvcc_runs": nvcc, "param_casts": casts,
                "kernel_launches": kernel_launches()}

    def _push_stats(self) -> None:
        try:
            st = self._engine.stats()
        except Exception:   # noqa: BLE001 — engine mid-shutdown
            return
        st["worker_frame_errors"] = self.frame_errors
        st.update(self._build_account())
        if self._transport is not None:
            st["kv_wire_bytes"] = int(self._transport.wire_bytes)
            st["kv_ships"] = int(self._transport.shipped)
        self._publish("stats", {"stats": st})

    def _load(self) -> int:
        try:
            st = self._engine.stats()
            return int(st.get("queue_depth", 0)) + \
                int(st.get("active_slots", 0))
        except Exception:   # noqa: BLE001
            return 0

    def _hb_loop(self, interval: float) -> None:
        ticks = 0
        while not self._stop.wait(interval):
            try:
                self._membership.beat(self.rid, self._load())
            except Exception:   # noqa: BLE001 — coordinator outage: the
                pass            # membership's retry and backoff heal it
            ticks += 1
            if ticks % 4 == 0:
                self._push_stats()

    def run(self) -> int:
        import torch

        from ..models import transformer_lm_conf
        from ..models.generation import (SlotGenerationEngine,
                                         TransformerDecoder)
        from ..nn.graph import ComputationGraph
        from ..parallel.faults import FaultInjector
        from ..parallel.preemption import PreemptionHandler
        from ..streaming.journal import (RequestJournal,
                                         recover_from_journal)
        from .disagg import SerializedKVTransport

        stages = [("imports", time.monotonic())]
        cfg = self.cfg
        model = cfg["model"]
        eng_cfg = dict(cfg.get("engine") or {})
        # f32 weights from the model dict's seed, on the card unless the
        # config says "cpu": every process builds the same bits
        net = ComputationGraph(transformer_lm_conf(
            model["vocab"], d_model=model["d_model"],
            num_heads=model["num_heads"],
            num_layers=model["num_layers"],
            max_length=model["max_length"],
            learning_rate=model.get("learning_rate", 1e-2),
            seed=model.get("seed", 5)), device=cfg.get("device")).init()
        dec = TransformerDecoder(net, t_max=eng_cfg.get("t_max"))
        # the one weight cast, at boot: a wave after the hello casts
        # nothing, whether or not this worker served before it
        dec._device_params()
        self._decoder = dec
        stages.append(("weights", time.monotonic()))
        digest = params_digest(net)
        stages.append(("digest", time.monotonic()))
        jr = RequestJournal(cfg["journal_dir"], fsync="every_n",
                            fsync_n=4)
        inj = None
        slow = float(os.environ.get("DL4J_SOAK_SLOW", "0") or 0)
        if slow > 0:
            inj = FaultInjector()
            inj.hang_for("engine.step", seconds=slow, at=1,
                         times=1_000_000)
        paged = bool(eng_cfg.get("paged", self.role != "both"))
        handoff = self._handoff_sink if self.role == ROLE_PREFILL \
            else None
        if self.role == ROLE_PREFILL:
            self._transport = SerializedKVTransport(record_ships=True)
        broker_host, broker_port = cfg["broker"]
        kv_host, kv_port = cfg["kv"]
        drain_budget = float(cfg.get("drain_budget", 8.0))
        eng = SlotGenerationEngine(
            net, num_slots=int(eng_cfg.get("num_slots", 2)),
            decoder=dec, block_size=int(eng_cfg.get("block_size", 1)),
            max_pending=int(eng_cfg.get("max_pending", 256)),
            paged=paged, page_size=int(eng_cfg.get("page_size", 16)),
            phase=self.role, handoff=handoff, journal=jr,
            fault_injector=inj).start()
        self._engine = eng
        handler = PreemptionHandler(
            eng, jr, deadline=drain_budget,
            manifest_dir=cfg["journal_dir"]).install()
        self._broker = TcpMessageBroker(broker_host, int(broker_port))
        cmd_q = self._broker.subscribe(self._cmd_topic)
        kv_client = CoordinatorKVClient(kv_host, int(kv_port))
        self._membership = KVFleetMembership(kv_client,
                                             fleet_id=self.fleet_id)
        self._membership.register(self.rid)

        recovery = recover_from_journal(jr, eng)
        # a request that finished just before a kill: its result rebuilt
        # from the journal's retired tokens, durable exactly once across
        # SIGKILL
        for rid_ in recovery.already_done:
            e = recovery.entries[rid_]
            if e.status == "done" and e.prompt is not None:
                self._remember(rid_, {"id": rid_, "ok": True,
                                      "src": "journal",
                                      "gen": e.tokens()})
        for req in recovery.requests:
            self._track(str(req.journal_id), req)
        stages.append(("engine", time.monotonic()))
        # seconds a boot stage took, from this module's start, and the
        # CPU seconds this process spent up to here (the interpreter's
        # start and its imports included)
        boot, t_prev = {}, _MODULE_T0
        for name, t in stages:
            boot[name] = round(t - t_prev, 4)
            t_prev = t
        boot["cpu_s"] = round(time.process_time(), 4)

        device = net.device
        self._publish("hello", {
            "role": self.role,
            "num_slots": eng.num_slots,
            "max_pending": eng.max_pending,
            "recovered": recovery.to_dict(),
            "device": device.type,
            "device_name": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu",
            "params_digest": digest, "boot": boot,
            **self._build_account()})
        print(f"worker {self.rid}@{self.epoch} pid {os.getpid()} on "
              f"{device}: hello; boot seconds from the module's start "
              f"{boot}", flush=True)
        self._audit_snap = self._builds()
        hb = float(cfg.get("heartbeat_interval", 0.25))
        self._hb_thread = threading.Thread(
            target=self._hb_loop, args=(hb,), daemon=True,
            name=f"rworker-{self.rid}-hb")
        self._hb_thread.start()

        while not self._stop.is_set() and not handler.preempted:
            try:
                payload = cmd_q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                kind, meta, body = decode_rpc(payload)
            except RpcFrameError:
                self.frame_errors += 1
                continue
            try:
                self._handle_cmd(kind, meta, body)
            except Exception as e:   # noqa: BLE001 — a cmd bug must not
                # kill the serve loop; it is reported instead
                self._publish("worker_error",
                              {"cmd": kind, "error": str(e)})

        report: Dict[str, Any] = {"preempted": handler.preempted}
        if handler.preempted:
            handler.wait(drain_budget + 10)
            report["drain"] = None if handler.report is None \
                else handler.report.to_dict()
        report.update(self._build_account())
        self._stop.set()
        self._publish("drained", {"report": report})
        try:
            self._membership.leave(self.rid)
        except Exception:   # noqa: BLE001 — the coordinator may be gone
            pass
        if not handler.preempted:
            eng.shutdown()
        jr.close()
        try:
            self._broker.close()
        except Exception:   # noqa: BLE001
            pass
        kv_client.close()
        return 0


def worker_main(config_path: str) -> int:
    """Entry point of a replica process (``python -m
    deeplearning4j_tpu_torch.streaming.remote <config.json>``)."""
    with open(config_path, encoding="utf-8") as f:
        cfg = json.load(f)
    return RemoteWorker(cfg).run()


if __name__ == "__main__":      # pragma: no cover — subprocess entry
    if len(sys.argv) != 2:
        print("usage: python -m deeplearning4j_tpu_torch.streaming.remote "
              "<config.json>", file=sys.stderr)
        sys.exit(2)
    sys.exit(worker_main(sys.argv[1]))
