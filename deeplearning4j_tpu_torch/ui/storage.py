"""StatsStorage backends: the JAX package's ``ui/storage.py``, the same
host code (reference core api/storage/StatsStorage.java and the ui-model
storage implementations: InMemoryStatsStorage, FileStatsStorage, sqlite).

Records are plain dicts with ``session`` / ``type`` / ``iteration`` keys.
Backends: in memory, a JSONL file (FileStatsStorage) and sqlite."""

from __future__ import annotations

import json
import sqlite3
import threading
from pathlib import Path
from typing import Dict, List, Optional


class StatsStorage:
    """Router + query contract."""

    def put_update(self, record: Dict):
        raise NotImplementedError

    def put_static_info(self, record: Dict):
        raise NotImplementedError

    def list_sessions(self) -> List[str]:
        raise NotImplementedError

    def get_updates(self, session: str) -> List[Dict]:
        raise NotImplementedError

    def get_static_info(self, session: str) -> Optional[Dict]:
        raise NotImplementedError


class InMemoryStatsStorage(StatsStorage):
    def __init__(self):
        self._updates: Dict[str, List[Dict]] = {}
        self._static: Dict[str, Dict] = {}
        self._lock = threading.Lock()

    def put_update(self, record: Dict):
        with self._lock:
            self._updates.setdefault(record["session"], []).append(record)

    def put_static_info(self, record: Dict):
        with self._lock:
            self._static[record["session"]] = record

    def list_sessions(self) -> List[str]:
        return sorted(set(self._updates) | set(self._static))

    def get_updates(self, session: str) -> List[Dict]:
        return list(self._updates.get(session, []))

    def get_static_info(self, session: str) -> Optional[Dict]:
        return self._static.get(session)


class FileStatsStorage(StatsStorage):
    """Append-only JSONL file (reference FileStatsStorage)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def _append(self, record: Dict):
        with self._lock, open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")

    def put_update(self, record: Dict):
        self._append(record)

    def put_static_info(self, record: Dict):
        self._append(record)

    def _read(self) -> List[Dict]:
        if not self.path.exists():
            return []
        out = []
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out

    def list_sessions(self) -> List[str]:
        return sorted({r["session"] for r in self._read()})

    def get_updates(self, session: str) -> List[Dict]:
        # every non-static record type (update/histogram/flow/
        # convolutional) is an update — filtering to 'update' alone
        # silently hid the legacy listeners' records from the UI tabs
        return [r for r in self._read()
                if r["session"] == session and r.get("type") != "init"]

    def get_static_info(self, session: str) -> Optional[Dict]:
        for r in self._read():
            if r["session"] == session and r["type"] == "init":
                return r
        return None


class SqliteStatsStorage(StatsStorage):
    """sqlite-backed storage (reference J7FileStatsStorage/sqlite)."""

    def __init__(self, path):
        self.path = str(path)
        self._lock = threading.Lock()
        with self._conn() as c:
            c.execute("CREATE TABLE IF NOT EXISTS records ("
                      "session TEXT, type TEXT, iteration INTEGER, "
                      "payload TEXT)")
            c.execute("CREATE INDEX IF NOT EXISTS idx_session ON "
                      "records(session, type, iteration)")

    def _conn(self):
        return sqlite3.connect(self.path)

    def put_update(self, record: Dict):
        with self._lock, self._conn() as c:
            c.execute("INSERT INTO records VALUES (?, ?, ?, ?)",
                      (record["session"], "update",
                       record.get("iteration", 0), json.dumps(record)))

    def put_static_info(self, record: Dict):
        with self._lock, self._conn() as c:
            c.execute("INSERT INTO records VALUES (?, ?, ?, ?)",
                      (record["session"], "init", 0, json.dumps(record)))

    def list_sessions(self) -> List[str]:
        with self._conn() as c:
            rows = c.execute("SELECT DISTINCT session FROM records").fetchall()
        return sorted(r[0] for r in rows)

    def get_updates(self, session: str) -> List[Dict]:
        with self._conn() as c:
            rows = c.execute(
                "SELECT payload FROM records WHERE session=? AND type!="
                "'init' ORDER BY iteration", (session,)).fetchall()
        return [json.loads(r[0]) for r in rows]

    def get_static_info(self, session: str) -> Optional[Dict]:
        with self._conn() as c:
            row = c.execute(
                "SELECT payload FROM records WHERE session=? AND type='init'",
                (session,)).fetchone()
        return json.loads(row[0]) if row else None
