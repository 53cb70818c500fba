"""Stats storage SPI and implementations.

Parity with ``deeplearning4j-core/.../api/storage/StatsStorage.java`` (the
transport-agnostic persistence SPI: sessions → type IDs → worker IDs →
timestamped updates, plus static per-session info and change listeners) and
the impls in ``deeplearning4j-ui-model`` (`InMemoryStatsStorage.java`,
`MapDBStatsStorage.java` → here a JSON-lines file store, no native DB).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional


class Persistable:
    """A JSON-serializable record identified by (session, type, worker,
    timestamp) — the reference's SBE-encoded Persistable, minus SBE."""

    def __init__(self, session_id: str, type_id: str, worker_id: str,
                 timestamp: float, data: Dict[str, Any]):
        self.session_id = session_id
        self.type_id = type_id
        self.worker_id = worker_id
        self.timestamp = float(timestamp)
        self.data = data

    def to_json(self) -> str:
        return json.dumps({"session_id": self.session_id, "type_id": self.type_id,
                           "worker_id": self.worker_id, "timestamp": self.timestamp,
                           "data": self.data})

    @staticmethod
    def from_json(s: str) -> "Persistable":
        d = json.loads(s)
        return Persistable(d["session_id"], d["type_id"], d["worker_id"],
                           d["timestamp"], d["data"])


class StatsStorageEvent:
    NEW_SESSION = "new_session"
    NEW_TYPE_ID = "new_type_id"
    NEW_WORKER_ID = "new_worker_id"
    POST_STATIC_INFO = "post_static_info"
    POST_UPDATE = "post_update"

    def __init__(self, kind: str, session_id: str, type_id: Optional[str] = None,
                 worker_id: Optional[str] = None, timestamp: Optional[float] = None):
        self.kind = kind
        self.session_id = session_id
        self.type_id = type_id
        self.worker_id = worker_id
        self.timestamp = timestamp


class StatsStorageListener:
    def notify(self, event: StatsStorageEvent) -> None:  # pragma: no cover
        pass


class StatsStorageRouter:
    """Write-side SPI (``StatsStorageRouter.java``)."""

    def put_static_info(self, p: Persistable) -> None:
        raise NotImplementedError

    def put_update(self, p: Persistable) -> None:
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Read+write storage (``StatsStorage.java:28``)."""

    def __init__(self):
        self._static: Dict[tuple, Persistable] = {}
        self._updates: Dict[tuple, List[Persistable]] = {}
        self._listeners: List[StatsStorageListener] = []
        self._lock = threading.Lock()
        self._closed = False

    # -- write ----------------------------------------------------------
    def put_static_info(self, p: Persistable) -> None:
        with self._lock:
            is_new_session = not self._session_exists_unlocked(p.session_id)
            self._static[(p.session_id, p.type_id, p.worker_id)] = p
            self._persist(p, static=True)
        if is_new_session:
            self._notify(StatsStorageEvent(StatsStorageEvent.NEW_SESSION, p.session_id))
        self._notify(StatsStorageEvent(StatsStorageEvent.POST_STATIC_INFO,
                                       p.session_id, p.type_id, p.worker_id))

    def put_update(self, p: Persistable) -> None:
        with self._lock:
            is_new_session = not self._session_exists_unlocked(p.session_id)
            key = (p.session_id, p.type_id, p.worker_id)
            self._updates.setdefault(key, []).append(p)
            self._persist(p, static=False)
        if is_new_session:
            self._notify(StatsStorageEvent(StatsStorageEvent.NEW_SESSION, p.session_id))
        self._notify(StatsStorageEvent(StatsStorageEvent.POST_UPDATE,
                                       p.session_id, p.type_id, p.worker_id,
                                       p.timestamp))

    def _persist(self, p: Persistable, static: bool) -> None:
        pass  # overridden by file-backed storage

    # -- read -----------------------------------------------------------
    def _session_exists_unlocked(self, sid: str) -> bool:
        return (any(k[0] == sid for k in self._static)
                or any(k[0] == sid for k in self._updates))

    def list_session_ids(self) -> List[str]:
        with self._lock:
            out = {k[0] for k in self._static} | {k[0] for k in self._updates}
        return sorted(out)

    def session_exists(self, sid: str) -> bool:
        with self._lock:
            return self._session_exists_unlocked(sid)

    def list_type_ids_for_session(self, sid: str) -> List[str]:
        with self._lock:
            out = ({k[1] for k in self._static if k[0] == sid}
                   | {k[1] for k in self._updates if k[0] == sid})
        return sorted(out)

    def list_worker_ids_for_session(self, sid: str,
                                    type_id: Optional[str] = None) -> List[str]:
        with self._lock:
            keys = list(self._static) + list(self._updates)
            out = {k[2] for k in keys
                   if k[0] == sid and (type_id is None or k[1] == type_id)}
        return sorted(out)

    def get_static_info(self, sid: str, type_id: str, worker_id: str) -> Optional[Persistable]:
        with self._lock:
            return self._static.get((sid, type_id, worker_id))

    def get_all_static_infos(self, sid: str, type_id: str) -> List[Persistable]:
        with self._lock:
            return [p for k, p in self._static.items()
                    if k[0] == sid and k[1] == type_id]

    def get_num_update_records_for(self, sid: str, type_id: Optional[str] = None,
                                   worker_id: Optional[str] = None) -> int:
        with self._lock:
            return sum(len(v) for k, v in self._updates.items()
                       if k[0] == sid and (type_id is None or k[1] == type_id)
                       and (worker_id is None or k[2] == worker_id))

    def get_latest_update(self, sid: str, type_id: str, worker_id: str) -> Optional[Persistable]:
        with self._lock:
            lst = self._updates.get((sid, type_id, worker_id))
            return lst[-1] if lst else None

    def get_latest_update_all_workers(self, sid: str, type_id: str) -> List[Persistable]:
        with self._lock:
            return [v[-1] for k, v in self._updates.items()
                    if k[0] == sid and k[1] == type_id and v]

    def get_all_updates_after(self, sid: str, type_id: str,
                              timestamp: float,
                              worker_id: Optional[str] = None) -> List[Persistable]:
        with self._lock:
            out = []
            for k, v in self._updates.items():
                if k[0] == sid and k[1] == type_id and \
                        (worker_id is None or k[2] == worker_id):
                    out.extend(p for p in v if p.timestamp > timestamp)
        return sorted(out, key=lambda p: p.timestamp)

    def get_all_update_times(self, sid: str, type_id: str, worker_id: str) -> List[float]:
        with self._lock:
            return [p.timestamp for p in self._updates.get((sid, type_id, worker_id), [])]

    # -- listeners / lifecycle -------------------------------------------
    def register_stats_storage_listener(self, l: StatsStorageListener) -> None:
        self._listeners.append(l)

    def deregister_stats_storage_listener(self, l: StatsStorageListener) -> None:
        self._listeners.remove(l)

    def remove_all_listeners(self) -> None:
        self._listeners.clear()

    def _notify(self, event: StatsStorageEvent) -> None:
        for l in list(self._listeners):
            l.notify(event)

    def close(self) -> None:
        self._closed = True

    def is_closed(self) -> bool:
        return self._closed


class InMemoryStatsStorage(StatsStorage):
    """Pure in-memory storage (``InMemoryStatsStorage.java``)."""


class FileStatsStorage(StatsStorage):
    """Append-only JSON-lines file storage — the durable, inspectable
    replacement for the reference's MapDB-backed store
    (``MapDBStatsStorage.java``). Reloads existing records on open."""

    def __init__(self, path: str):
        super().__init__()
        self.path = str(path)
        if os.path.exists(self.path):
            with open(self.path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    p = Persistable(rec["session_id"], rec["type_id"],
                                    rec["worker_id"], rec["timestamp"], rec["data"])
                    key = (p.session_id, p.type_id, p.worker_id)
                    if rec.get("static"):
                        self._static[key] = p
                    else:
                        self._updates.setdefault(key, []).append(p)
        self._fh = open(self.path, "a", encoding="utf-8")

    def _persist(self, p: Persistable, static: bool) -> None:
        rec = {"session_id": p.session_id, "type_id": p.type_id,
               "worker_id": p.worker_id, "timestamp": p.timestamp,
               "static": static, "data": p.data}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        super().close()
        self._fh.close()
