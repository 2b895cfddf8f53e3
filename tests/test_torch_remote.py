"""PyTorch port: the process-per-replica fleet's protocol seams
(``streaming/remote.py``), in process, against the JAX package's
``streaming/remote.py``. Every case of the JAX package's
``tests/test_remote.py`` has a counterpart here: the RPC codec under
truncation, bit flips, hostile lengths and duplicated frames (always the
typed RpcFrameError), the coordinator KV's framing and its server's
resilience to hostile frames, the proxy's exactly-once fences (worker
epoch, pending-map identity, dispatch retry until ACK), the broker's
publish deadline under a black-hole partition and the membership's
degraded mode. Cross-package: frames byte-identical from both encoders,
each decoder taking the other's frames and refusing the same damaged
ones, each package's KV client against the other's server, and the same
rebuilt error classes. The launcher's worker config names the card
unless the caller asks for the CPU; the module imports neither ``jax``
nor the JAX package, and the port's linter finds nothing in it or in
``streaming/tcp_broker.py``, as the JAX package's gate holds its copies."""

import ast
import json
import os
import queue
import socket
import struct
import sys
import threading
import time
import zlib

import pytest

import deeplearning4j_tpu.streaming.remote as jax_remote
import deeplearning4j_tpu_torch.streaming.remote as port_remote
from deeplearning4j_tpu_torch.observability.integrity import NumericalFault
from deeplearning4j_tpu_torch.parallel.faults import (Cancelled,
                                                      DeadlineExceeded,
                                                      RejectedError)
from deeplearning4j_tpu_torch.streaming.fleet import KVFleetMembership
from deeplearning4j_tpu_torch.streaming.remote import (MAX_KV_MESSAGE,
                                                       MAX_RPC_HEADER,
                                                       CoordinatorKVClient,
                                                       CoordinatorKVServer,
                                                       RemoteReplicaError,
                                                       RemoteReplicaProxy,
                                                       ReplicaProcessLauncher,
                                                       RpcFrameError,
                                                       _kv_recv, _kv_send,
                                                       _rebuild_error,
                                                       decode_rpc,
                                                       encode_rpc)
from deeplearning4j_tpu_torch.streaming.tcp_broker import TcpMessageBroker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ===================================================================
# RPC codec fuzzing
# ===================================================================
class TestRpcCodec:
    def test_round_trip_with_body(self):
        body = bytes(range(256)) * 3
        kind, meta, out = decode_rpc(
            encode_rpc("dispatch", {"id": "r1", "prompt": [1, 2]}, body))
        assert kind == "dispatch"
        assert meta == {"id": "r1", "prompt": [1, 2]}
        assert out == body

    def test_round_trip_empty_body(self):
        kind, meta, body = decode_rpc(encode_rpc("ping", {}))
        assert (kind, meta, body) == ("ping", {}, b"")

    def test_every_truncation_is_typed(self):
        frame = encode_rpc("result", {"id": "x", "ok": True}, b"tok")
        for cut in range(len(frame)):
            with pytest.raises(RpcFrameError):
                decode_rpc(frame[:cut])

    def test_single_bit_flips_are_typed(self):
        # each mutant raises RpcFrameError or decodes to the original
        # content; it never silently yields different content
        frame = encode_rpc("ack", {"id": "y"}, b"payload")
        for pos in range(len(frame)):
            mutant = bytearray(frame)
            mutant[pos] ^= 0x01
            try:
                kind, meta, body = decode_rpc(bytes(mutant))
            except RpcFrameError:
                continue
            assert (kind, meta, body) == ("ack", {"id": "y"}, b"payload")

    def test_bad_magic_and_version(self):
        frame = bytearray(encode_rpc("ping", {}))
        with pytest.raises(RpcFrameError, match="magic"):
            decode_rpc(b"XXXX" + bytes(frame[4:]))
        frame[4] = 250                       # version byte
        with pytest.raises(RpcFrameError, match="version"):
            decode_rpc(bytes(frame))

    def test_hostile_header_length_claims(self):
        frame = bytearray(encode_rpc("ping", {}))
        struct.pack_into("<I", frame, 5, 2 ** 31)
        with pytest.raises(RpcFrameError, match="hostile header"):
            decode_rpc(bytes(frame))
        struct.pack_into("<I", frame, 5, MAX_RPC_HEADER)
        with pytest.raises(RpcFrameError, match="hostile header"):
            decode_rpc(bytes(frame))

    def test_hostile_body_length_claims(self):
        good = encode_rpc("evt", {"n": 1}, b"abcd")
        with pytest.raises(RpcFrameError, match="hostile body"):
            decode_rpc(good + b"JUNK")
        # a duplicated (concatenated) frame is one bad datagram
        with pytest.raises(RpcFrameError, match="hostile body"):
            decode_rpc(good + good)

    def test_crc_flips_detected(self):
        frame = bytearray(encode_rpc("evt", {"a": 1}, b"body"))
        frame[9 + 2] ^= 0xFF                 # inside the JSON header
        with pytest.raises(RpcFrameError, match="header crc"):
            decode_rpc(bytes(frame))
        frame = bytearray(encode_rpc("evt", {"a": 1}, b"body"))
        frame[-1] ^= 0xFF                    # inside the body
        with pytest.raises(RpcFrameError, match="body crc"):
            decode_rpc(bytes(frame))

    def test_header_must_be_typed_json_object(self):
        def forge(header: bytes) -> bytes:
            return b"".join([
                b"DRPC", struct.pack("<BI", 1, len(header)), header,
                struct.pack("<I", zlib.crc32(header) & 0xFFFFFFFF),
                struct.pack("<QI", 0, zlib.crc32(b"") & 0xFFFFFFFF)])

        with pytest.raises(RpcFrameError, match="JSON"):
            decode_rpc(forge(b"\xff\xfenot json"))
        for payload in (b"[1,2]", b'{"k":7,"m":{}}', b'{"k":"x","m":[]}',
                        b'{"k":"x"}'):
            with pytest.raises(RpcFrameError, match="must be"):
                decode_rpc(forge(payload))

    def test_oversized_header_rejected_at_encode(self):
        with pytest.raises(ValueError, match="body"):
            encode_rpc("dispatch", {"blob": "x" * (MAX_RPC_HEADER + 1)})


# ===================================================================
# the wire across the two packages
# ===================================================================
FRAME_CASES = [
    ("ping", {}, b""),
    ("dispatch", {"id": "req-001", "prompt": [3, 1, 4], "max_new": 6,
                  "temperature": 0.0, "eos": None, "timeout": None,
                  "gen": []}, b""),
    ("adopt", {"id": "r9", "gen": [7], "n_pages": 2, "nbytes": 4096,
               "tok_bytes": 16, "epoch": 3}, bytes(range(256)) * 17),
    ("result", {"id": "x", "ok": False, "src": "live",
                "error": {"type": "DeadlineExceeded", "msg": "late ü"}},
     b""),
    ("stats", {"stats": {"queue_depth": 2, "active_slots": 1,
                         "kernel_launches": {"shortseq_attention": 5}},
               "epoch": 1}, b""),
    ("kv_dir", {"prefix": "dl4j/fleet/f0/"}, b""),
    ("evt", {"nested": {"a": [1.5, -2, True, None, "s"]}}, b"\x00\xff"),
]


@pytest.mark.parametrize("kind,meta,body", FRAME_CASES,
                         ids=[c[0] for c in FRAME_CASES])
def test_frames_byte_identical_across_packages(kind, meta, body):
    frame = port_remote.encode_rpc(kind, meta, body)
    assert frame == jax_remote.encode_rpc(kind, meta, body)
    assert jax_remote.decode_rpc(frame) == (kind, meta, body)
    assert port_remote.decode_rpc(frame) == (kind, meta, body)


@pytest.mark.parametrize("encoder,decoder", [
    ("port", "jax"), ("jax", "port")])
def test_decoders_refuse_the_same_damaged_frames(encoder, decoder):
    enc = {"port": port_remote, "jax": jax_remote}[encoder].encode_rpc
    dec_mod = {"port": port_remote, "jax": jax_remote}[decoder]
    other = jax_remote if dec_mod is port_remote else port_remote
    frame = enc("result", {"id": "x", "ok": True, "gen": [1, 2]}, b"tok")
    assert dec_mod.decode_rpc(frame) == other.decode_rpc(frame)
    mutants = [frame[:cut] for cut in range(len(frame))]
    for pos in range(len(frame)):
        m = bytearray(frame)
        m[pos] ^= 0x10
        mutants.append(bytes(m))
    mutants += [frame + b"J", frame + frame]
    for m in mutants:
        outs = []
        for mod in (dec_mod, other):
            try:
                outs.append(("ok", mod.decode_rpc(m)))
            except mod.RpcFrameError as e:
                outs.append(("err", str(e)))
        assert outs[0] == outs[1], m


def test_port_kv_client_against_jax_server_and_back():
    for srv_mod, cli_mod in ((jax_remote, port_remote),
                             (port_remote, jax_remote)):
        srv = srv_mod.CoordinatorKVServer()
        cli = cli_mod.CoordinatorKVClient("127.0.0.1", srv.port,
                                          timeout=3.0)
        try:
            cli.key_value_set("/x/a", "1")
            cli.key_value_set("/x/b", "2")
            assert sorted(cli.key_value_dir_get("/x/")) == \
                [("/x/a", "1"), ("/x/b", "2")]
            with pytest.raises(RuntimeError, match="exists"):
                cli.key_value_set("/x/a", "9")
            cli.key_value_delete("/x/a")
            assert cli.key_value_dir_get("/x/") == [("/x/b", "2")]
            assert srv.snapshot() == {"/x/b": "2"}
        finally:
            cli.close()
            srv.close()


def test_membership_beats_cross_packages_through_the_kv():
    """A port worker's KVFleetMembership beats into a JAX coordinator
    server and the port router reads the same row."""
    srv = jax_remote.CoordinatorKVServer()
    cli = CoordinatorKVClient("127.0.0.1", srv.port, timeout=3.0)
    try:
        worker = KVFleetMembership(cli, "xf0")
        worker.beat("w0", 3)
        router = KVFleetMembership(cli, "xf0")
        assert "w0" in router.ages()
    finally:
        cli.close()
        srv.close()


ERROR_DOCS = [{"type": t, "msg": "m"} for t in (
    "NumericalFault", "DeadlineExceeded", "Cancelled", "RejectedError",
    "SomethingWeird", "")] + [{}, "not a dict"]


@pytest.mark.parametrize("doc", ERROR_DOCS, ids=[str(i) for i in
                                                 range(len(ERROR_DOCS))])
def test_rebuild_error_classes_match_jax(doc):
    got = port_remote._rebuild_error(doc)
    want = jax_remote._rebuild_error(doc)
    assert type(got).__name__ == type(want).__name__
    assert str(got) == str(want)


# ===================================================================
# coordinator KV: framing + server resilience
# ===================================================================
class TestCoordinatorKV:
    def test_kv_recv_rejects_hostile_length_claim(self):
        a, b = socket.socketpair()
        try:
            a.sendall(struct.pack("<Q", MAX_KV_MESSAGE + 1))
            with pytest.raises(ConnectionError, match="ceiling"):
                _kv_recv(b)
        finally:
            a.close()
            b.close()

    def test_kv_send_recv_round_trip(self):
        a, b = socket.socketpair()
        try:
            _kv_send(a, b"hello-kv")
            assert _kv_recv(b) == b"hello-kv"
        finally:
            a.close()
            b.close()

    def test_server_round_trip_write_once_and_delete(self):
        srv = CoordinatorKVServer()
        cli = CoordinatorKVClient("127.0.0.1", srv.port, timeout=3.0)
        try:
            cli.key_value_set("/a/x", "1")
            cli.key_value_set("/a/y", "2")
            assert sorted(cli.key_value_dir_get("/a/")) == \
                [("/a/x", "1"), ("/a/y", "2")]
            with pytest.raises(RuntimeError, match="exists"):
                cli.key_value_set("/a/x", "9")     # write-once
            cli.key_value_delete("/a/x")
            assert cli.key_value_dir_get("/a/") == [("/a/y", "2")]
        finally:
            cli.close()
            srv.close()

    def test_server_survives_hostile_frame_and_keeps_serving(self):
        srv = CoordinatorKVServer()
        try:
            raw = socket.create_connection(("127.0.0.1", srv.port),
                                           timeout=3.0)
            try:
                raw.settimeout(3.0)
                _kv_send(raw, b"THIS IS NOT AN RPC FRAME")
                kind, meta, _ = decode_rpc(_kv_recv(raw))
                assert kind == "err"
                # the same connection still serves valid requests
                _kv_send(raw, encode_rpc("kv_set", {"key": "k",
                                                    "value": "v"}))
                kind, _, _ = decode_rpc(_kv_recv(raw))
                assert kind == "ok"
            finally:
                raw.close()
            assert srv.frame_errors == 1
            assert srv.snapshot() == {"k": "v"}
        finally:
            srv.close()

    def test_concurrent_clients_checkout_contention(self):
        # the client's lock guards the connection's ownership only:
        # contending callers dial their own socket and all succeed
        srv = CoordinatorKVServer()
        cli = CoordinatorKVClient("127.0.0.1", srv.port, timeout=5.0)
        errs = []

        def hammer(i):
            try:
                for j in range(25):
                    cli.key_value_set(f"/h/{i}/{j}", str(j))
            except Exception as e:   # noqa: BLE001 — collected, asserted
                errs.append(e)

        try:
            ts = [threading.Thread(target=hammer, args=(i,))
                  for i in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30.0)
            assert not any(t.is_alive() for t in ts)
            assert not errs, errs
            assert len(cli.key_value_dir_get("/h/")) == 100
        finally:
            cli.close()
            srv.close()

    def test_closed_client_raises_typed(self):
        srv = CoordinatorKVServer()
        cli = CoordinatorKVClient("127.0.0.1", srv.port)
        try:
            cli.close()
            with pytest.raises(ConnectionError, match="closed"):
                cli.key_value_set("a", "b")
        finally:
            srv.close()


# ===================================================================
# proxy fencing: the exactly-once arms, driven deterministically
# ===================================================================
class _FakeBroker:
    """In-process broker double: subscribe hands out a Queue; publish
    records every frame per topic (and feeds subscribed queues)."""

    def __init__(self):
        self.published = {}
        self._subs = {}

    def subscribe(self, topic):
        q = queue.Queue()
        self._subs.setdefault(topic, []).append(q)
        return q

    def unsubscribe(self, topic, q):
        self._subs.get(topic, [])[:] = \
            [x for x in self._subs.get(topic, []) if x is not q]

    def publish(self, topic, frame):
        self.published.setdefault(topic, []).append(bytes(frame))
        for q in self._subs.get(topic, []):
            q.put(bytes(frame))


def _mk_proxy(**kw):
    broker = _FakeBroker()
    proxy = RemoteReplicaProxy(broker, "w0", "tf0", **kw)
    return broker, proxy


class TestProxyFencing:
    def test_hello_adopts_epoch_and_geometry(self):
        _, proxy = _mk_proxy()
        proxy._handle_evt("hello", {"epoch": 3, "num_slots": 7}, b"")
        assert proxy.hello.is_set()
        assert proxy.epoch == 3 and proxy.num_slots == 7
        # a lower-epoch hello (a stale incarnation rejoining late) does
        # not regress the adopted epoch
        proxy._handle_evt("hello", {"epoch": 1, "num_slots": 2}, b"")
        assert proxy.epoch == 3 and proxy.num_slots == 7

    def test_stale_epoch_events_fenced(self):
        _, proxy = _mk_proxy()
        proxy._handle_evt("hello", {"epoch": 2}, b"")
        req = proxy.submit([1, 2], 3)
        rid = req.journal_id
        proxy._handle_evt("result", {"epoch": 1, "id": rid, "ok": True,
                                     "gen": [9, 9, 9]}, b"")
        assert proxy.counters["stale_epoch"] == 1
        assert not req.done()
        proxy._handle_evt("result", {"epoch": 2, "id": rid, "ok": True,
                                     "gen": [4, 5, 6]}, b"")
        assert req.done() and req.generated == [4, 5, 6]

    def test_duplicate_result_fenced_by_pending_identity(self):
        _, proxy = _mk_proxy()
        req = proxy.submit([1, 2], 2)
        meta = {"epoch": 0, "id": req.journal_id, "ok": True,
                "gen": [7, 8]}
        proxy._handle_evt("result", meta, b"")
        assert req.done() and proxy.counters["results"] == 1
        proxy._handle_evt("result", dict(meta), b"")   # replay
        assert proxy.counters["fenced_results"] == 1
        assert proxy.counters["results"] == 1
        assert req.generated == [7, 8]                 # unchanged

    def test_unsolicited_result_fenced(self):
        _, proxy = _mk_proxy()
        proxy._handle_evt("result", {"epoch": 0, "id": "never-sent",
                                     "ok": True, "gen": [1]}, b"")
        assert proxy.counters["fenced_results"] == 1

    def test_late_result_after_quarantine_fenced(self):
        _, proxy = _mk_proxy()
        req = proxy.submit([3], 2)
        rid = req.journal_id
        handles, cause = proxy.quarantine()
        assert handles == [] and cause is not None
        proxy._handle_evt("result", {"epoch": 0, "id": rid, "ok": True,
                                     "gen": [1, 2]}, b"")
        assert proxy.counters["fenced_results"] == 1
        assert not req.done()        # migration owns completion now

    def test_dispatch_retry_until_ack(self):
        broker, proxy = _mk_proxy(ack_timeout=0.05, retry_interval=0.02)
        proxy.start()
        try:
            req = proxy.submit([1], 2)
            topic = proxy._cmd_topic
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and \
                    len(broker.published[topic]) < 3:
                time.sleep(0.01)
            # the unACKed dispatch re-published byte-identical
            frames = broker.published[topic]
            assert len(frames) >= 3
            assert frames[0] == frames[1] == frames[2]
            assert proxy.counters["dispatch_retries"] >= 2
            proxy._handle_evt("ack", {"epoch": 0,
                                      "id": req.journal_id}, b"")
            n = len(broker.published[topic])
            time.sleep(0.15)
            assert len(broker.published[topic]) == n
        finally:
            proxy.shutdown()

    def test_retry_budget_exhaustion_fails_handle_typed(self):
        _, proxy = _mk_proxy(ack_timeout=0.02, retry_interval=0.01,
                             max_dispatch_retries=2)
        proxy.start()
        try:
            req = proxy.submit([1], 2)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and not req.done():
                time.sleep(0.01)
            assert req.done()
            with pytest.raises(RemoteReplicaError, match="no ack"):
                req.result(0)
        finally:
            proxy.shutdown()

    def test_malformed_event_frame_counted_not_fatal(self):
        _, proxy = _mk_proxy()
        proxy.start()
        try:
            proxy._queue.put(b"garbage that is not an rpc frame")
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and \
                    proxy.counters["frame_errors"] == 0:
                time.sleep(0.01)
            assert proxy.counters["frame_errors"] == 1
            proxy._queue.put(encode_rpc("hello", {"epoch": 1}))
            assert proxy.hello.wait(5.0)
        finally:
            proxy.shutdown()

    def test_rebuild_error_preserves_slo_classes(self):
        assert isinstance(_rebuild_error({"type": "DeadlineExceeded",
                                          "msg": "x"}), DeadlineExceeded)
        assert isinstance(_rebuild_error({"type": "Cancelled",
                                          "msg": "x"}), Cancelled)
        assert isinstance(_rebuild_error({"type": "RejectedError",
                                          "msg": "x"}), RejectedError)
        assert isinstance(_rebuild_error({"type": "NumericalFault",
                                          "msg": "x"}), NumericalFault)
        exc = _rebuild_error({"type": "SomethingWeird", "msg": "boom"})
        assert isinstance(exc, RemoteReplicaError)
        assert "SomethingWeird" in str(exc)


# ===================================================================
# broker publish deadline under a black-hole partition
# ===================================================================
class TestBrokerPartition:
    def test_publish_to_never_reading_server_bounded_and_counted(self):
        # a raw server that accepts and never reads: the OS buffers fill
        # and sendall would block for ever without the send deadline,
        # which turns the wedge into a counted drop
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(8)
        port = srv.getsockname()[1]
        conns = []
        stop = threading.Event()

        def accept_loop():
            while not stop.is_set():
                try:
                    c, _ = srv.accept()
                    conns.append(c)
                except OSError:
                    return

        threading.Thread(target=accept_loop, daemon=True).start()
        cli = TcpMessageBroker("127.0.0.1", port, publish_deadline=1.0,
                               max_reconnect_attempts=2,
                               backoff_cap=0.2)
        try:
            payload = b"x" * (1 << 20)
            t0 = time.monotonic()
            for _ in range(64):
                cli.publish("t", payload)
                if cli.publish_drops:
                    break
            wall = time.monotonic() - t0
            assert cli.publish_drops >= 1, \
                "black-holed publish never hit the counted-drop path"
            assert wall < 20.0, f"publish loop wedged for {wall:.1f}s"
            t1 = time.monotonic()
            cli.publish("t", payload)
            assert time.monotonic() - t1 < 5.0
        finally:
            stop.set()
            cli.close()
            srv.close()
            for c in conns:
                try:
                    c.close()
                except OSError:
                    pass


# ===================================================================
# membership degraded mode (coordinator unreachable)
# ===================================================================
class _FlakyKV:
    """Write-once KV double whose next ``fail_for`` calls raise
    ConnectionError: a transient coordinator outage."""

    def __init__(self):
        self.store = {}
        self.fail_for = 0

    def _maybe_fail(self):
        if self.fail_for > 0:
            self.fail_for -= 1
            raise ConnectionError("coordinator unreachable")

    def key_value_set(self, k, v):
        self._maybe_fail()
        if k in self.store:
            raise RuntimeError("exists")
        self.store[k] = v

    def key_value_dir_get(self, prefix):
        self._maybe_fail()
        return [(k, v) for k, v in self.store.items()
                if k.startswith(prefix)]

    def key_value_delete(self, k):
        self.store.pop(k, None)


class TestMembershipDegraded:
    def test_transient_outage_absorbed_by_retry(self):
        kv = _FlakyKV()
        m = KVFleetMembership(kv, "tm0", epoch=5, retry_base=0.01)
        m.beat("r0", 1)
        assert not m.degraded
        kv.fail_for = 2                   # the third attempt succeeds
        ages = m.ages()
        assert "r0" in ages
        assert not m.degraded

    def test_total_outage_degrades_and_local_cache_keeps_aging(self):
        kv = _FlakyKV()
        m = KVFleetMembership(kv, "tm1", epoch=5, retry_base=0.01)
        m.beat("r0", 1)
        m.ages()            # one good scan seeds the local view
        kv.fail_for = 10 ** 6
        a1 = m.ages()
        assert m.degraded and "r0" in a1
        time.sleep(0.05)
        a2 = m.ages()
        # members age toward SUSPECT through the outage
        assert a2["r0"][0] > a1["r0"][0]
        m.beat("r0", 2)
        assert m.degraded
        kv.fail_for = 0
        m.ages()
        assert not m.degraded
        m.beat("r0", 3)
        assert not m.degraded

    def test_nonconnection_beat_errors_not_retried(self):
        # a write-once duplicate (a rejoin race) is not an outage
        kv = _FlakyKV()
        m = KVFleetMembership(kv, "tm2", epoch=5, retry_base=0.01)
        m.beat("r0", 1)
        m._seq["r0"] -= 1                 # force a key collision
        m.beat("r0", 2)
        assert not m.degraded


# ===================================================================
# the port's own contracts
# ===================================================================
def test_remote_module_imports_no_jax():
    """The module imports neither jax nor the JAX package (the port's
    own lint gate is the test below)."""
    path = os.path.join(REPO, "deeplearning4j_tpu_torch", "streaming",
                        "remote.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu")]
    assert not bad, bad


def test_remote_module_lint_clean():
    """As the JAX package's ``TestRemoteLintClean``: the port's remote
    tier ships with ZERO findings of the port's linter — not zero beyond
    its baseline; zero."""
    from deeplearning4j_tpu_torch.analysis import lint_paths
    paths = [os.path.join(REPO, "deeplearning4j_tpu_torch", "streaming", f)
             for f in ("remote.py", "tcp_broker.py")]
    found = lint_paths(paths, repo_root=REPO)
    assert found == [], "\n".join(str(f) for f in found)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_launcher_config_names_the_card_unless_asked(tmp_path, monkeypatch,
                                                     device):
    """A worker's config carries ``device`` (None: the CUDA card), the
    launcher starts ``python -m deeplearning4j_tpu_torch.streaming.remote``
    with the repository on PYTHONPATH, and nothing in the child's
    environment hides the card."""
    seen = {}

    class FakePopen:
        pid = 4242

        def __init__(self, argv, env=None, cwd=None, stdout=None,
                     stderr=None):
            seen.update(argv=argv, env=env, cwd=cwd)

        def poll(self):
            return None

        def wait(self, timeout=None):
            return 0

    monkeypatch.setattr(port_remote.subprocess, "Popen", FakePopen)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    la = ReplicaProcessLauncher(
        str(tmp_path), broker_addr=("127.0.0.1", 1),
        kv_addr=("127.0.0.1", 2), fleet_id="f0",
        model={"vocab": 12}, engine={"num_slots": 2}, device=device)
    row = {"proc": None, "epoch": 1, "role": "both", "stopping": False,
           "restarts": 0, "extra": None}
    la._spawn_locked("w0", row)
    with open(seen["argv"][-1], encoding="utf-8") as f:
        cfg = json.load(f)
    assert cfg["device"] == device
    assert cfg["rid"] == "w0" and cfg["engine"] == {"num_slots": 2}
    assert seen["argv"][:3] == [sys.executable, "-m",
                                "deeplearning4j_tpu_torch.streaming.remote"]
    assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert seen["cwd"] == REPO
    assert "JAX_PLATFORMS" not in seen["env"]
    assert "CUDA_VISIBLE_DEVICES" not in seen["env"]
    assert la.log_path("w0", 1).endswith(os.path.join("w0",
                                                      "worker-1.log"))


def test_endpoint_shut_down_before_its_start_spawns_nothing(tmp_path,
                                                            monkeypatch):
    """A boot in one thread and a shutdown in another: ``start`` spawns
    under the endpoint's lock, so a shutdown that came first leaves no
    worker to orphan (the start returns without spawning)."""
    spawned = []
    monkeypatch.setattr(
        port_remote.ReplicaProcessLauncher, "spawn",
        lambda self, rid, role="both", extra=None: spawned.append(rid))
    ep = port_remote.FleetEndpoint(str(tmp_path), {"vocab": 12},
                                   engine={"num_slots": 2}, device="cpu",
                                   hello_deadline=1.0)
    ep.shutdown()
    assert ep.start() is ep
    assert spawned == [] and ep.pids() == {}


def test_boot_probe_times_a_worker_boot_on_the_cpu():
    """``tools/boot_probe.py`` starts fresh interpreters that import what a
    worker imports and touch the device, and reports each one's CPU
    seconds and stages."""
    from deeplearning4j_tpu_torch.tools import boot_probe
    w = boot_probe.boot_wave(1, "cpu")
    assert w["n"] == 1 and len(w["processes"]) == 1
    end_s, cpu_s, stages = w["processes"][0]
    assert 0 < end_s <= w["wall_s"] and cpu_s > 0
    assert stages.startswith("torch ") and " package " in stages \
        and " device " in stages
