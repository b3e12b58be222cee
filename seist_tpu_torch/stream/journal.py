"""Durable streaming state: per-station session journals + an alert WAL
(the port's copy of ``seist_tpu/stream/journal.py``: the same bytes on
disk, so a journal written by one package restores in the other).

Failover story: when a
replica dies, the router re-homes its stations to survivors by rendezvous
hash; the survivor's first packet for an orphaned station finds the dead
replica's last journal entry here and resumes the session mid-record —
the snapshot/restore parity pin means picks continue exactly where the
journal watermark left them. No journal (never written, corrupt, version
skew) degrades to a fresh session: the stream plane already stitches
through sequence gaps, so the station re-warms instead of erroring.

Two artifacts, two durability contracts:

* :class:`StationJournal` — one ``<station>.npz`` per station under
  ``<root>/<model>/stations/``, REPLACED atomically on every write
  (dotfile + ``os.replace``, the ``obs/flight.py`` idiom): a reader
  never sees a torn file, and a crash mid-write leaves the previous
  journal intact. Entries are O(window) by construction — the session's
  ring/curve trims bound the snapshot, so journal size is independent of
  stream length. Router affinity guarantees a single writer per station
  file; the directory itself is shared by the fleet (that sharing IS the
  failover channel).
* :class:`AlertWAL` — append-only JSONL, one fsync'd line per emitted
  alert, written BEFORE the alert becomes visible to any consumer
  (durable-before-visible). Replay after a restart seeds the
  associator's dedup window so a re-formed event hypothesis is
  suppressed instead of double-alerting; corrupt trailing lines (torn
  final append) are skipped, never fatal.

State bytes are ``np.savez_compressed`` with the JSON meta riding as a
uint8 array — one self-describing blob, no sidecar files to tear.
"""

from __future__ import annotations

import io
import json
import os
import threading
from typing import Dict, List, Mapping, Optional

import numpy as np

from seist_tpu_torch.utils.faults import stream_faults

__all__ = [
    "AlertWAL",
    "StationJournal",
    "state_from_bytes",
    "state_to_bytes",
]


# ----------------------------------------------------------- state codec
def state_to_bytes(state: Mapping[str, object]) -> bytes:
    """Pack a ``StreamSession.snapshot()`` dict into one npz blob."""
    meta = json.dumps(state["meta"], separators=(",", ":")).encode()
    arrays = {k: np.asarray(v) for k, v in state["arrays"].items()}
    buf = io.BytesIO()
    np.savez_compressed(
        buf, __meta__=np.frombuffer(meta, np.uint8), **arrays
    )
    return buf.getvalue()


def state_from_bytes(blob: bytes) -> Dict[str, object]:
    """Inverse of :func:`state_to_bytes`. Raises on any corruption —
    callers map that to "no journal" (fresh session re-warm)."""
    with np.load(io.BytesIO(blob)) as z:
        meta = json.loads(z["__meta__"].tobytes().decode())
        arrays = {k: np.array(z[k]) for k in z.files if k != "__meta__"}
    return {"meta": meta, "arrays": arrays}


def _slug(s: str) -> str:
    out = "".join(c if (c.isalnum() or c in "-_.") else "_" for c in s)
    return out[:128] or "default"


# ------------------------------------------------------- station journal
class StationJournal:
    """Atomic per-station session journal under ``<root>/<model>/stations``.

    ``write`` is the hot path (one per station per journal interval):
    serialize, write a dotfile (invisible to ``*.npz`` listings), rename
    into place. ``load`` returns ``None`` for missing OR unreadable
    journals — the caller cannot do anything smarter with a corrupt file
    than with an absent one, and the distinction is surfaced through the
    ``corrupt_reads`` counter instead of an exception."""

    def __init__(self, root: str, model: str = "default") -> None:
        self.root = os.path.join(root, _slug(model), "stations")
        os.makedirs(self.root, exist_ok=True)
        self.writes = 0
        self.corrupt_reads = 0

    def _path(self, station_id: str) -> str:
        return os.path.join(self.root, _slug(station_id) + ".npz")

    def write(self, station_id: str, state: Mapping[str, object]) -> str:
        path = self._path(station_id)
        blob = state_to_bytes(state)
        # Fault lane: SEIST_FAULT_STREAM_JOURNAL_CORRUPT_P truncates the
        # blob mid-write for hash-selected stations so failover exercises
        # the torn-journal -> fresh-session path deterministically.
        inj = stream_faults()
        if inj.corrupt_journal(station_id):
            blob = blob[: max(1, len(blob) // 2)]
        tmp = os.path.join(
            self.root, "." + os.path.basename(path) + ".tmp"
        )
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        self.writes += 1
        return path

    def load(self, station_id: str) -> Optional[Dict[str, object]]:
        path = self._path(station_id)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        try:
            return state_from_bytes(blob)
        except Exception:  # noqa: BLE001 - corrupt journal == no journal
            self.corrupt_reads += 1
            return None

    def remove(self, station_id: str) -> None:
        try:
            os.remove(self._path(station_id))
        except OSError:
            pass

    def station_ids(self) -> List[str]:
        """Slugged station ids with a journal on disk (sorted)."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(
            n[: -len(".npz")]
            for n in names
            if n.endswith(".npz") and not n.startswith(".")
        )


# ------------------------------------------------------------- alert WAL
class AlertWAL:
    """Append-only JSONL alert log, one fsync'd line per alert.

    The associator appends INSIDE its emit path, before the alert is
    returned to any caller — an alert a consumer could have seen is
    always on disk first, so a crash between emit and delivery re-emits
    (at-least-once) and the dedup window turns that into exactly-once
    for the consumer."""

    def __init__(self, path: str) -> None:
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self.appends = 0

    def append(self, record: Mapping[str, object]) -> None:
        line = json.dumps(record, separators=(",", ":"), default=str)
        with self._lock:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
            self.appends += 1

    def replay(self) -> List[Dict[str, object]]:
        """All intact records, oldest first; torn lines are skipped."""
        out: List[Dict[str, object]] = []
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            return out
        return out
