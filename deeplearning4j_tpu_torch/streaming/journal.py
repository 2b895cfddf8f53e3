"""Durable request journal: a crash-safe write-ahead log for the
serving path, and the recovery that replays it — the JAX package's
``streaming/journal.py``, copied, with the same frame format: a journal
written by the JAX engine replays here, and one written here replays
there.

EngineSupervisor recovers in-process crashes; a whole-process SIGKILL or
a preemption of the machine loses every in-flight and queued request
unless they are on disk. This module closes that gap:

- :class:`RequestJournal` — an append-only, CRC-framed JSONL
  write-ahead log of request lifecycle. The engine writes ``sub``
  (prompt + sampling params + the ORIGINAL wall-clock submission time),
  ``ret`` (tokens appended at decode-block boundaries — batched per
  block, written OUTSIDE the engine lock on the readback thread, with
  each record carrying the ABSOLUTE token offset so replay is
  idempotent and duplicate-tolerant), ``req`` (requeue/takeover
  markers) and ``fin`` (done/failed/cancelled) records. Deterministic
  re-prefill (prompt + retired tokens → token-identical continuation)
  is already proven by the supervisor's requeue path; the journal is
  just enough durable state to drive that same path from disk.

  Durability knobs: ``fsync`` policy ``"always"`` (fsync per append
  batch), ``"every_n"`` (per N records) or ``"interval"`` (at most
  every T seconds); segment rotation at ``segment_bytes`` with
  compaction (completed ids dropped, open ids consolidated to one
  ``sub`` + one ``ret`` frame) — the journal's disk footprint tracks
  OPEN work, not total traffic.

  Degraded mode: journal I/O errors NEVER fail serving. Writes retry
  with backoff (sleeps outside the journal lock), then flip the
  ``journal_degraded`` gauge and count drops; later successes clear
  the gauge. A journal that cannot even open its directory serves
  zero-durability but the engine keeps decoding.

- :func:`replay_journal` / :func:`recover_from_journal` — replay the
  segments (truncating at the last valid CRC frame per segment: a torn
  final record after SIGKILL is tolerated, logged to the flight
  recorder, and never crashes recovery), reconstruct every unfinished
  request (prompt + retired tokens, original SLO clocks re-anchored
  through the recorded wall time so queue-wait/TTFT/deadline headroom
  SPAN the outage), and requeue them — recovery bypasses admission
  control exactly like a supervisor takeover. Replay is a bag-merge
  keyed by request id with absolute token offsets, so it is idempotent:
  a crash mid-recovery re-recovers cleanly, and a zombie's straggler
  records cannot corrupt the stream its clone owns.

  Fleet fencing: journal ids reuse request ids, and when a
  :class:`.fleet.FleetLedger` is passed the ledger's completion fence
  is the single arbiter — a restarted replica's recovered request is
  skipped if a surviving router already re-dispatched a clone
  (assignee moved) or already completed it, so cross-process recovery
  never duplicates work.

Proof harness: ``tools/chaos_soak.py --process-kill`` SIGKILLs a
child serving process mid-stream, SIGTERMs it for a drain round
(:class:`..parallel.preemption.PreemptionHandler`), restarts it, and
asserts zero lost, zero duplicated (ledger-verified), token-identical
outputs with SLO clocks continuous across the outage.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import weakref
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from ..observability.flightrec import default_flight_recorder
from ..observability.tracing import interval_now
from ..observability.metrics import default_registry

#: journal record kinds (the WAL vocabulary)
KINDS = ("sub", "ret", "req", "fin")
#: terminal statuses a ``fin`` record may carry
FIN_STATUSES = ("done", "failed", "cancelled")

_JOURNAL_SEQ = itertools.count()

#: journal counters: metric suffix → help text (one labeled child per
#: journal instance, label ``journal=<id>`` — same registry discipline
#: as the engine/route/fleet counters)
_JOURNAL_COUNTERS = {
    "records": "journal records appended (all kinds)",
    "fsyncs": "explicit fsync calls issued",
    "dropped_records": "records dropped after I/O retry exhaustion "
                       "(degraded mode)",
    "io_errors": "journal I/O failures (open/write/fsync/rotate)",
    "rotations": "segment rotations",
    "compactions": "segment compactions (completed ids dropped)",
    "truncated_frames": "invalid/torn frames truncated at replay",
    "recovered_requests": "requests reconstructed and requeued by "
                          "recover_from_journal",
}


def _frame(doc: dict) -> bytes:
    """One CRC-framed JSONL record: ``<crc32:8hex> <json>\\n``. The CRC
    covers the json bytes; replay truncates at the first frame whose
    CRC, framing, or JSON fails — a torn tail after SIGKILL never
    poisons the records before it."""
    body = json.dumps(doc, separators=(",", ":")).encode("utf-8")
    return b"%08x " % (zlib.crc32(body) & 0xffffffff) + body + b"\n"


def _parse_frame(line: bytes) -> Optional[dict]:
    """Validate + decode one frame; None means invalid/torn."""
    if not line.endswith(b"\n") or len(line) < 11 or line[8:9] != b" ":
        return None
    body = line[9:-1]
    try:
        crc = int(line[:8], 16)
    except ValueError:
        return None
    if zlib.crc32(body) & 0xffffffff != crc:
        return None
    try:
        doc = json.loads(body)
    except ValueError:
        return None
    return doc if isinstance(doc, dict) else None


class JournalEntry:
    """Replay product for one request id: the bag-merge of every record
    that names it. ``toks`` is position-addressed (absolute offsets from
    ``ret`` records), so duplicate or out-of-order retires collapse
    instead of corrupting the stream."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "temperature",
                 "eos_id", "deadline", "created_wall", "route", "status",
                 "error", "requeues", "_toks")

    def __init__(self, rid: str):
        self.rid = rid
        self.prompt: Optional[List[int]] = None
        self.max_new_tokens: Optional[int] = None
        self.temperature = 0.0
        self.eos_id: Optional[int] = None
        self.deadline: Optional[float] = None
        self.created_wall: Optional[float] = None
        self.route: Optional[str] = None
        self.status = "open"               # open | done | failed | cancelled
        self.error: Optional[str] = None
        self.requeues = 0
        self._toks: List[Optional[int]] = []

    def place_tokens(self, base: int, toks: Sequence[int]) -> None:
        base = int(base)
        end = base + len(toks)
        if end > len(self._toks):
            self._toks.extend([None] * (end - len(self._toks)))
        for i, t in enumerate(toks):
            self._toks[base + i] = int(t)

    def tokens(self) -> List[int]:
        """Longest contiguous retired prefix — the resume point. A gap
        (lost middle record) truncates the resume there; decoding just
        regenerates the rest deterministically."""
        out: List[int] = []
        for t in self._toks:
            if t is None:
                break
            out.append(t)
        return out

    @property
    def recoverable(self) -> bool:
        """A usable ``sub`` record exists (status is the CALLER's check:
        recovery reconstructs open entries — and, ledger permitting,
        resurrects terminal ones a zombie's straggler fin mislabeled)."""
        return self.prompt is not None and self.max_new_tokens is not None

    def to_dict(self) -> dict:
        return {"rid": self.rid, "status": self.status,
                "prompt_len": None if self.prompt is None
                else len(self.prompt),
                "generated": len(self.tokens()),
                "max_new_tokens": self.max_new_tokens,
                "requeues": self.requeues, "route": self.route,
                "error": self.error}


def _apply_record(entries: Dict[str, JournalEntry], doc: dict) -> None:
    """Merge one decoded record into the replay state (bag semantics:
    order-tolerant per id; first ``sub`` wins the prompt/params, any
    ``fin`` wins terminal status)."""
    rid = doc.get("id")
    kind = doc.get("k")
    if not isinstance(rid, str) or kind not in KINDS:
        return
    e = entries.get(rid)
    if e is None:
        e = entries[rid] = JournalEntry(rid)
    if kind == "sub":
        if e.prompt is None:
            try:
                e.prompt = [int(t) for t in doc.get("p", ())]
                e.max_new_tokens = int(doc.get("mnt", 0))
                e.temperature = float(doc.get("temp", 0.0))
                e.eos_id = doc.get("eos")
                if e.eos_id is not None:
                    e.eos_id = int(e.eos_id)
                dl = doc.get("dl")
                e.deadline = None if dl is None else float(dl)
                e.created_wall = float(doc.get("wall", time.time()))
                e.route = doc.get("route")
            except (TypeError, ValueError):
                e.prompt = None            # torn sub: unrecoverable id
    elif kind == "ret":
        try:
            e.place_tokens(int(doc.get("b", 0)), doc.get("t", ()))
        except (TypeError, ValueError):
            pass
    elif kind == "req":
        e.requeues += 1
    elif kind == "fin":
        st = doc.get("st")
        if st in FIN_STATUSES:
            e.status = st
            e.error = doc.get("err")


def _segment_paths(directory: str) -> List[str]:
    """Journal segments in sequence order (``wal-<seq>.log``)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    segs = []
    for n in names:
        if n.startswith("wal-") and n.endswith(".log"):
            try:
                segs.append((int(n[4:-4]), os.path.join(directory, n)))
            except ValueError:
                continue
    return [p for _, p in sorted(segs)]


def replay_journal(directory: str,
                   flight_recorder=None) -> Tuple[Dict[str, JournalEntry],
                                                  dict]:
    """Replay every segment in ``directory``. Each segment is read
    frame-by-frame and TRUNCATED at its first invalid frame (bad CRC,
    torn tail, undecodable JSON) — the frames before it are kept, the
    rest of that segment is dropped and counted, and replay moves on to
    the next segment. Never raises on corrupt data; an unreadable
    directory replays to empty. Returns ``(entries, report)``."""
    entries: Dict[str, JournalEntry] = {}
    report = {"segments": 0, "records": 0, "truncated_frames": 0,
              "truncated_segments": [], "unreadable_segments": []}
    for path in _segment_paths(directory):
        report["segments"] += 1
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            report["unreadable_segments"].append(os.path.basename(path))
            continue
        pos = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            line = data[pos:] if nl < 0 else data[pos:nl + 1]
            doc = _parse_frame(line)
            if doc is None:
                # truncate THIS segment at the last valid frame: a torn
                # final record (SIGKILL mid-write) is expected; anything
                # after an invalid frame is untrustworthy either way
                report["truncated_frames"] += 1
                report["truncated_segments"].append(
                    os.path.basename(path))
                if flight_recorder is not None:
                    flight_recorder.record(
                        "journal", event="truncated",
                        segment=os.path.basename(path),
                        at_byte=pos, tail_bytes=len(data) - pos)
                break
            _apply_record(entries, doc)
            report["records"] += 1
            pos = nl + 1
    return entries, report


class RequestJournal:
    """Append-only CRC-framed JSONL write-ahead log of request
    lifecycle, with segment rotation/compaction and degraded-mode I/O.

    Thread contract: every public write method may be called from any
    thread (the engine calls them from its readback thread, OUTSIDE the
    engine lock: nothing here is ever executed under an engine
    lock, and the journal's own lock never wraps a retry sleep).
    Barrier fsyncs DO run under the journal lock on the appending
    thread — that is the policy's stated price (amortized 1/``fsync_n``
    appends under ``every_n``, every append under ``always``), and
    concurrent ``pending``/``stats`` readers wait it out; what the lock
    never buys is a blocked ENGINE (journal calls happen outside its
    locks) or an unbounded stall (retry sleeps are lock-free).

    Everything is INLINE on the calling thread — deliberately no
    background writer: on the host-bound decode shapes the A/B gate
    measures, a second Python thread contending for the GIL costs more
    than the I/O it hides (measured ~20% vs ~3%). An append under the
    ``every_n``/``interval`` policies is one buffered ``write()``;
    records ride the stdio buffer between barriers (a SIGKILL loses at
    most the un-fsynced tail, which recovery regenerates
    deterministically), and the barrier's flush+fsync amortizes over
    ``fsync_n`` records. ``fsync="always"`` fsyncs every append —
    strict durability, priced accordingly. I/O-retry backoff sleeps
    happen with no lock held."""

    def __init__(self, directory: str, *, fsync: str = "every_n",
                 fsync_n: int = 256, fsync_interval: float = 0.05,
                 segment_bytes: int = 1 << 20, retries: int = 3,
                 retry_backoff: float = 0.01, registry=None,
                 flight_recorder=None, fault_injector=None):
        if fsync not in ("always", "every_n", "interval"):
            raise ValueError(f"fsync policy '{fsync}' not in "
                             "('always', 'every_n', 'interval')")
        self.directory = str(directory)
        self.fsync_policy = fsync
        self.fsync_n = max(1, int(fsync_n))
        self.fsync_interval = float(fsync_interval)
        self.segment_bytes = int(segment_bytes)
        self.retries = max(0, int(retries))
        self.retry_backoff = float(retry_backoff)
        self.journal_id = f"j{next(_JOURNAL_SEQ)}"
        self._flightrec = flight_recorder if flight_recorder is not None \
            else default_flight_recorder()
        # ``journal.write`` fault point: fires once
        # per append ATTEMPT inside the retry loop, so chaos_soak can
        # drive the WAL's whole degraded lifecycle (retry → backoff →
        # journal_degraded gauge → drop-count → heal) from the injector
        # instead of unit-level monkeypatching. Arm with OSError; any
        # other injected exception type is coerced so the degraded
        # contract (serving NEVER fails on journal I/O) cannot be
        # broken by a mis-armed plan.
        from ..parallel.faults import NULL_INJECTOR
        self._faults = fault_injector if fault_injector is not None \
            else NULL_INJECTOR
        self._lock = threading.Lock()
        self._fh = None                    # active segment file object
        self._seg_seq = 0
        self._seg_bytes = 0
        self._closed = False
        self._degraded = False
        self._since_sync = 0
        self._last_sync = time.monotonic()
        # id → "open" | terminal status: drives the pending gauge and
        # compaction's completed-id drop (seeded from disk at open)
        self._state: Dict[str, str] = {}

        reg = registry if registry is not None else default_registry()
        self._m = {key: reg.counter(f"journal_{key}_total", desc,
                                    ("journal",)).labels(self.journal_id)
                   for key, desc in _JOURNAL_COUNTERS.items()}
        self._m_records = self._m["records"]   # hot-path child, cached
        wself = weakref.ref(self)
        reg.gauge("journal_pending",
                  "journaled requests not yet terminal",
                  ("journal",)).labels(self.journal_id).set_function(
            lambda: (lambda s: 0 if s is None else s.pending)(wself()))
        self._g_degraded = reg.gauge(
            "journal_degraded",
            "1 while journal I/O is failing (serving continues, "
            "durability degraded)", ("journal",)).labels(self.journal_id)
        self._g_degraded.set(0)
        reg.gauge("journal_bytes", "bytes across live journal segments",
                  ("journal",)).labels(self.journal_id).set_function(
            lambda: (lambda s: 0 if s is None else s.bytes)(wself()))

        # seed state from any prior incarnation's segments, then open a
        # FRESH active segment — never append after a possibly-torn tail
        entries, rep = replay_journal(self.directory, self._flightrec)
        if rep["truncated_frames"]:
            self._m["truncated_frames"].inc(rep["truncated_frames"])
        for rid, e in entries.items():
            self._state[rid] = e.status
        with self._lock:
            segs = _segment_paths(self.directory)
            if segs:
                tail = os.path.basename(segs[-1])
                self._seg_seq = int(tail[4:-4])
            self._open_active_locked()

    # ------------------------------------------------------------ file I/O
    def _open_active_locked(self) -> bool:
        """Open the next active segment (caller holds ``_lock``);
        returns False on failure (degraded)."""
        try:
            os.makedirs(self.directory, exist_ok=True)
            self._seg_seq += 1
            path = os.path.join(self.directory,
                                f"wal-{self._seg_seq:08d}.log")
            self._fh = open(path, "ab", buffering=1 << 16)
            self._seg_bytes = 0
            return True
        except OSError:
            self._fh = None
            self._m["io_errors"].inc()
            return False

    def _write_locked(self, payload: bytes, n_records: int) -> None:
        """One write attempt (caller holds ``_lock``); raises OSError on
        failure so the outer retry loop can back off lock-free. Flushes
        + fsyncs inline when the policy's barrier is due."""
        if self._fh is None and not self._open_active_locked():
            raise OSError("journal segment unavailable")
        self._fh.write(payload)
        self._seg_bytes += len(payload)
        self._since_sync += n_records
        due = self.fsync_policy == "always" or \
            (self.fsync_policy == "every_n" and
             self._since_sync >= self.fsync_n) or \
            (self.fsync_policy == "interval" and
             time.monotonic() - self._last_sync >= self.fsync_interval)
        if due:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._m["fsyncs"].inc()
            self._since_sync = 0
            self._last_sync = time.monotonic()

    def _append(self, docs: Sequence[dict]) -> bool:
        """Frame + write one batch of records as a single buffered
        write, with retry/backoff on failure (sleeps with no lock
        held); exhaustion flips degraded mode and drops the batch.
        While degraded, a single attempt per batch probes for recovery
        without stalling the readback thread behind a dead disk.
        Degraded-mode contract: NEVER raises — serving continues."""
        if not docs:
            return True
        return self._append_payload(b"".join(_frame(d) for d in docs),
                                    len(docs))

    def _append_payload(self, payload: bytes, n_records: int) -> bool:
        attempts = None
        for attempt in range(64):       # bound: attempts resolves to
            try:                        # <= retries+1 on first entry
                try:
                    # outside the journal lock, once per attempt — a
                    # raise IS this attempt's I/O failure
                    self._faults.fire("journal.write")
                except OSError:
                    raise
                except Exception as exc:   # noqa: BLE001 — coerce a
                    raise OSError(str(exc))   # mis-armed plan to I/O
                cleared = False
                with self._lock:
                    if self._closed:
                        return False
                    if attempts is None:
                        attempts = 1 if self._degraded \
                            else self.retries + 1
                    self._write_locked(payload, n_records)
                    rotate = self._seg_bytes >= self.segment_bytes
                    if self._degraded:
                        self._degraded = False
                        cleared = True
                if cleared:
                    self._g_degraded.set(0)
                self._m_records.inc(n_records)
                if rotate:
                    self._rotate()
                return True
            except OSError:
                self._m["io_errors"].inc()
                with self._lock:
                    if attempts is None:
                        attempts = 1 if self._degraded \
                            else self.retries + 1
                    # the handle may be poisoned (disk full, unlinked
                    # dir): drop it so the next attempt reopens
                    try:
                        if self._fh is not None:
                            self._fh.close()
                    except OSError:
                        pass
                    self._fh = None
                if attempt >= attempts - 1:
                    break
                time.sleep(self.retry_backoff * (2 ** attempt))
        with self._lock:
            first_failure = not self._degraded
            self._degraded = True
        if first_failure:
            self._g_degraded.set(1)
            self._flightrec.record("journal", event="degraded",
                                   journal=self.journal_id,
                                   dropped=n_records)
        self._m["dropped_records"].inc(n_records)
        return False

    # ----------------------------------------------------------- rotation
    def _rotate(self) -> None:
        """Close the active segment, compact every closed segment
        (completed ids dropped, open ids consolidated to one ``sub`` +
        one ``ret`` frame), open a fresh active segment. Crash-safe:
        the compacted segment is written to a tmp file, fsynced, and
        renamed before the stale segments are unlinked — replay's bag
        semantics make every intermediate state equivalent."""
        with self._lock:
            if self._closed:
                return
            try:
                if self._fh is not None:
                    self._fh.close()
            except OSError:
                self._m["io_errors"].inc()
            self._fh = None
        self._m["rotations"].inc()
        self.compact()
        with self._lock:
            if not self._closed:
                self._open_active_locked()

    def compact(self) -> bool:
        """Rewrite all closed segments into one consolidated segment,
        dropping completed ids. Failure is non-fatal (counted; stale
        segments simply survive until the next rotation).

        Known limit: compaction trusts the WAL's terminal records — it
        has (deliberately) no ledger access, so an id a zombie's
        straggler ``fin`` mislabeled loses its sub/ret records here,
        and the ledger-resurrection path in ``recover_from_journal``
        is best-effort UNTIL the next compaction. The window is the
        migration-detach race (rare) × segment-rotation cadence; the
        clone's own post-migration records re-open the id's presence
        either way."""
        entries, _ = replay_journal(self.directory, self._flightrec)
        old = _segment_paths(self.directory)
        with self._lock:
            active = None if self._fh is None else self._fh.name
        old = [p for p in old if p != active]
        if not old:
            return True
        docs: List[dict] = []
        for rid in sorted(entries):
            e = entries[rid]
            if e.status != "open":
                continue                   # completed: compacted away
            if e.prompt is not None:
                docs.append({"k": "sub", "id": rid, "p": e.prompt,
                             "mnt": e.max_new_tokens, "temp": e.temperature,
                             "eos": e.eos_id, "dl": e.deadline,
                             "wall": e.created_wall, "route": e.route})
            toks = e.tokens()
            if toks:
                docs.append({"k": "ret", "id": rid, "b": 0, "t": toks})
        with self._lock:
            seq = self._seg_seq + 1
            self._seg_seq = seq
        path = os.path.join(self.directory, f"wal-{seq:08d}.log")
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                for d in docs:
                    f.write(_frame(d))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            for p in old:
                os.unlink(p)
        except OSError:
            self._m["io_errors"].inc()
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        self._m["compactions"].inc()
        # forget terminal ids: their records are gone from disk now
        with self._lock:
            for rid in [r for r, st in self._state.items()
                        if st != "open"]:
                del self._state[rid]
        return True

    # ----------------------------------------------------------- recording
    def submitted(self, req, route: Optional[str] = None) -> None:
        """Journal a newly accepted request (prompt + params + the
        ORIGINAL wall-clock submission time, so a post-restart recovery
        re-anchors the SLO clocks across the outage)."""
        rid = getattr(req, "journal_id", None)
        if rid is None:
            return
        wall = time.time() - max(0.0, interval_now() - req._created_t)
        with self._lock:
            self._state.setdefault(rid, "open")
        self._append([{"k": "sub", "id": rid,
                       "p": [int(t) for t in req.prompt],
                       "mnt": int(req.max_new_tokens),
                       "temp": float(req.temperature),
                       "eos": None if req.eos_id is None
                       else int(req.eos_id),
                       "dl": req.deadline, "wall": wall,
                       "route": route}])

    def requeued(self, req) -> None:
        """Takeover/recovery marker — replay-inert, but it records the
        resume point for post-mortem forensics."""
        rid = getattr(req, "journal_id", None)
        if rid is None:
            return
        self._append([{"k": "req", "id": rid,
                       "n": len(req.generated)}])

    def retired(self, entries: Sequence[Tuple[str, int, Sequence[int]]]
                ) -> None:
        """Journal one decode block's token appends: ``(id, base,
        tokens)`` per lane, where ``base`` is the request's generated
        count BEFORE this block — absolute offsets make replay
        idempotent under duplicated or straggler records. One buffer
        write (and at most one fsync) per block.

        This is THE hot journal path (once per decode block): frames
        are built by hand instead of ``json.dumps`` — ids pass through
        ``json.dumps`` alone (escaping), int fields are formatted
        directly; the output parses identically."""
        parts = []
        n = 0
        for rid, base, toks in entries:
            if rid is None or not toks:
                continue
            body = ('{"k":"ret","id":%s,"b":%d,"t":[%s]}' % (
                json.dumps(rid), int(base),
                ",".join(str(int(t)) for t in toks))).encode("utf-8")
            parts.append(b"%08x " % (zlib.crc32(body) & 0xffffffff) +
                         body + b"\n")
            n += 1
        if parts:
            self._append_payload(b"".join(parts), n)

    def finished(self, rid: str, status: str,
                 error: Optional[str] = None) -> None:
        """Journal a terminal state; a ``done``/``failed``/``cancelled``
        id is never recovered and is dropped at the next compaction."""
        if rid is None or status not in FIN_STATUSES:
            return
        with self._lock:
            self._state[rid] = status
        doc = {"k": "fin", "id": rid, "st": status}
        if error:
            doc["err"] = str(error)[:200]
        self._append([doc])

    # ------------------------------------------------------------- control
    def sync(self) -> bool:
        """Force a flush + fsync NOW (the preemption drain's final
        barrier)."""
        try:
            with self._lock:
                if self._fh is None:
                    return False
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._since_sync = 0
                self._last_sync = time.monotonic()
            self._m["fsyncs"].inc()
            return True
        except OSError:
            self._m["io_errors"].inc()
            return False

    def close(self) -> None:
        self.sync()
        with self._lock:
            self._closed = True
            try:
                if self._fh is not None:
                    self._fh.close()
            except OSError:
                pass
            self._fh = None

    def replay(self) -> Tuple[Dict[str, JournalEntry], dict]:
        """Replay THIS journal's directory from disk (active segment
        included) — the recovery entry point. Flushes first so records
        appended this boot are visible."""
        self.sync()
        return replay_journal(self.directory, self._flightrec)

    # --------------------------------------------------------------- views
    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(1 for st in self._state.values() if st == "open")

    @property
    def bytes(self) -> int:
        total = 0
        for p in _segment_paths(self.directory):
            try:
                total += os.path.getsize(p)
            except OSError:
                continue
        return total

    def pending_ids(self) -> List[str]:
        with self._lock:
            return sorted(r for r, st in self._state.items()
                          if st == "open")

    def stats(self) -> dict:
        """Snapshot-source shape (``/snapshot`` sources and
        ``telemetry_dump --fleet`` surface it verbatim)."""
        with self._lock:
            pending = sum(1 for st in self._state.values()
                          if st == "open")
            degraded = self._degraded
            seq = self._seg_seq
        return {"journal_id": self.journal_id,
                "directory": self.directory,
                "pending": pending, "degraded": degraded,
                "bytes": self.bytes, "segments": len(
                    _segment_paths(self.directory)),
                "segment_seq": seq,
                "fsync_policy": self.fsync_policy,
                **{k: int(self._m[k].value) for k in _JOURNAL_COUNTERS}}


class RecoveryReport:
    """What :func:`recover_from_journal` did, for logs/tests/soaks."""

    def __init__(self):
        self.recovered: List[str] = []       # requeued ids
        self.completed: List[str] = []       # WAL held the full output:
        #                                      completed AT recovery, no
        #                                      decode (lost-fin window)
        self.already_done: List[str] = []    # terminal in the journal
        self.fenced: List[str] = []          # ledger: owned elsewhere /
        #                                      completed fleet-wide
        self.unrecoverable: List[str] = []   # no usable sub record
        self.truncated_frames = 0
        self.requests: List = []             # recovered + completed
        #                                      request objects
        self.entries: Dict[str, JournalEntry] = {}   # the replayed
        #                                      state (reusable: callers
        #                                      need not replay again)

    def to_dict(self) -> dict:
        return {"recovered": list(self.recovered),
                "completed": list(self.completed),
                "already_done": list(self.already_done),
                "fenced": list(self.fenced),
                "unrecoverable": list(self.unrecoverable),
                "truncated_frames": self.truncated_frames}

    def __repr__(self) -> str:
        return (f"<RecoveryReport recovered={len(self.recovered)} "
                f"done={len(self.already_done)} "
                f"fenced={len(self.fenced)} "
                f"unrecoverable={len(self.unrecoverable)}>")


def recover_from_journal(journal, engine, *, ledger=None,
                         replica_id: Optional[str] = None,
                         trace_store=None, tracing: bool = True,
                         flight_recorder=None) -> RecoveryReport:
    """Replay ``journal`` and requeue every unfinished request on
    ``engine`` (a ``SlotGenerationEngine``, ``EngineSupervisor``, or
    anything with the ``requeue`` surface).

    Each recovered request resumes with its prompt + retired tokens
    (the engine re-prefills and continues token-identically, the same
    contract as a supervisor takeover), its ORIGINAL SLO clocks
    re-anchored across the outage (``_created_t`` reconstructed from
    the journaled wall time, so queue-wait and deadline headroom span
    the downtime — an out-of-deadline request fails with
    ``DeadlineExceeded`` instead of silently resetting its budget), and
    a ``recovered`` span opening its fresh trace.

    ``ledger``/``replica_id`` fence recovery through the fleet's
    exactly-once arbiter: an id a surviving router already re-dispatched
    to another replica (assignee moved) or already completed is SKIPPED
    and counted — a restarted replica never duplicates a clone.

    Recovery is idempotent: it marks nothing in the journal; requeued
    requests journal their own resumption (``req`` marker + retires
    under the same id), so a crash mid-recovery simply re-recovers —
    already-finished ids are terminal, partially-decoded ones resume
    with more tokens."""
    import numpy as np

    from ..models.generation import GenerationRequest
    from ..observability.tracing import Trace, default_trace_ring

    flightrec = flight_recorder if flight_recorder is not None \
        else getattr(journal, "_flightrec", None) or \
        default_flight_recorder()
    entries, rep = journal.replay()
    report = RecoveryReport()
    report.entries = entries
    report.truncated_frames = int(rep.get("truncated_frames", 0))
    counters = getattr(journal, "_m", None)
    now_wall = time.time()
    now_mono = interval_now()
    for rid in sorted(entries):
        e = entries[rid]
        if e.status != "open":
            # a terminal record normally settles the id — EXCEPT when a
            # ledger still shows an OPEN assignment: a zombie's
            # straggler ``fin`` can race the migration detach and mark
            # the id its clone still owns. The ledger is the single
            # arbiter (completion pops the assignment), so an id that is
            # terminal-on-disk but assigned-in-ledger is resurrected and
            # falls through the normal fence checks below.
            if not (ledger is not None and e.recoverable and
                    ledger.assignee(rid) is not None):
                report.already_done.append(rid)
                continue
        elif not e.recoverable:
            report.unrecoverable.append(rid)
            flightrec.record("journal", event="unrecoverable", id=rid)
            continue
        holder = replica_id or "recovered"
        if ledger is not None:
            owner = ledger.assignee(rid)
            if owner is not None and replica_id is not None and \
                    owner != replica_id:
                # a surviving router already re-dispatched this id to a
                # live replica: recovering it here would race the clone
                report.fenced.append(rid)
                continue
            # ONE holder token for reassign AND the completed-from-WAL
            # try_complete below — a mismatch would leave a completed
            # id assigned (and resurrectable) forever
            holder = replica_id or owner or "recovered"
            if not ledger.try_reassign(rid, holder):
                report.fenced.append(rid)   # completed fleet-wide
                continue
        toks = e.tokens()
        req = GenerationRequest(np.asarray(e.prompt, np.int32),
                                e.max_new_tokens, e.temperature, e.eos_id)
        req.journal_id = rid
        req.generated = list(toks)
        # SLO clock continuity ACROSS THE PROCESS BOUNDARY: monotonic
        # clocks do not survive a restart, so the recorded wall time
        # re-anchors _created_t — queue-wait/TTFT/headroom span the
        # outage instead of resetting at recovery
        elapsed = max(0.0, now_wall - (e.created_wall or now_wall))
        req._created_t = now_mono - elapsed
        req._submit_t = req._created_t
        if e.deadline is not None:
            req.deadline = float(e.deadline)
            req._deadline_t = req._created_t + req.deadline
        req._slo_labels = {"route": e.route, "replica": replica_id}
        if tracing:
            req.trace = Trace(store=trace_store if trace_store is not None
                              else default_trace_ring())
            req.trace.event("recovered", journal=journal.journal_id,
                            generated=len(toks),
                            outage_s=round(elapsed, 3))
        # lost-fin window: the kill can land between the last ``ret``
        # and the ``fin`` — the WAL then holds the FULL continuation of
        # a request that already hit a stop condition. Requeueing it
        # would decode PAST the stop (the engine's admission check
        # catches exhausted budgets, but an eos-terminated stream looks
        # resumable to it) — complete it here instead, from the WAL.
        finished = len(toks) >= e.max_new_tokens or \
            (e.eos_id is not None and bool(toks) and
             toks[-1] == int(e.eos_id))
        if finished:
            flightrec.record("recovered", id=rid, generated=len(toks),
                             completed_from_wal=True)
            req._complete()
            journal.finished(rid, "done")
            if ledger is not None:
                ledger.try_complete(rid, holder)
            report.completed.append(rid)
            report.requests.append(req)
            continue
        flightrec.record("recovered", id=rid, generated=len(toks),
                         requeues=e.requeues,
                         outage_s=round(elapsed, 3))
        engine.requeue(req)
        report.recovered.append(rid)
        report.requests.append(req)
    if counters is not None and (report.recovered or report.completed):
        counters["recovered_requests"].inc(
            len(report.recovered) + len(report.completed))
    return report
