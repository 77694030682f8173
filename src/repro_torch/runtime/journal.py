"""Crash-consistent write-ahead journal of request lifecycle events (the
port of `repro.runtime.journal`: the same schema, events, keys and
torn-tail and alien-header rules, so a journal written by either package
replays in the other to the same summary).

MemPool's shared L1 is the single structure every PE trusts; our serving
analogue (`ServeSession` + the paged KV pool) concentrates every
in-flight request's state in one process. This module is the durability
half of that trust: an append-only, fsync'd JSONL log of request
lifecycle events (submit / admit / chunk-commit / finish / snapshot /
restore) that a restarted process replays to rebuild a consistent
scheduler state with **exactly-once** token delivery — tokens recorded
by a `commit` event are never re-delivered after a crash; greedy decode
regenerates them bit-identically and the session suppresses the
duplicate prefix (`Request.suppress_until`).

File format (schema-versioned JSONL, one event per line):

    {"version": 1, "kind": "repro-serve-journal"}          <- header
    {"seq": 0, "ev": "submit", "rid": 0, "prompt": [...],
     "max_new": 8, "klass": "throughput", "deadline_s": null}
    {"seq": 1, "ev": "admit", "rid": 0, "slot": 2, "chunk": 1}
    {"seq": 2, "ev": "commit", "rid": 0, "tokens": [5, 9], "chunk": 1}
    {"seq": 3, "ev": "finish", "rid": 0, "status": "done", "reason": null}
    {"seq": 4, "ev": "snapshot", "step": 4}
    {"seq": 5, "ev": "restore", "snapshot_step": 4, "replayed": 3}

Events are appended with a monotonically increasing ``seq`` and flushed
+ fsync'd once per poll (`commit()`), so the on-disk tail is at most one
chunk behind the delivered stream. A process killed mid-write leaves at
worst one torn final line; `read_events` treats a torn/corrupt tail as
the end of the log (the event was never acknowledged) and never raises.
A corrupt or alien header loads as an empty log — cold start.
`compact()` rewrites the file atomically (tmp + `os.replace`).

`replay(events)` is a pure function of the event list — replaying twice
is idempotent by construction, which the property tests assert.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from pathlib import Path
from typing import Iterable

SCHEMA_VERSION = 1
JOURNAL_KIND = "repro-serve-journal"

EVENTS = ("submit", "admit", "commit", "finish", "snapshot", "restore")
FINISH_STATUSES = ("done", "failed", "cancelled")


class Journal:
    """Append-mode handle on a journal file.

    Opening an existing file scans it once to recover the next ``seq``
    (tolerating a torn tail); opening a fresh path writes the header.
    `append` buffers, `commit` flushes + fsyncs — callers batch all of a
    poll's events into one fsync.

    ``fsync`` picks the durability/throughput point: ``True`` fsyncs
    every commit (power-fail durable — the default), ``False`` only
    flushes to the OS (durable against process death: a SIGKILL'd
    process loses nothing the page cache holds, only a kernel crash or
    power cut can), and an int ``K`` group-commits — flush every
    commit, fsync every Kth (Redis ``appendfsync``-style: the power-
    loss window is bounded by K polls, process-crash consistency is
    unchanged).

    ``tag`` (optional) is a dict merged into every appended event — the
    sharded session passes ``{"group": g}`` so each group's journal is
    self-describing (a restore can verify a journal belongs to the group
    directory it sits in). Untagged journals from single-group sessions
    replay identically: the tag is additive, never required.
    """

    def __init__(self, path: str | os.PathLike, *,
                 fsync: bool | int = True,
                 tag: dict | None = None):
        self.path = Path(path)
        self.fsync = fsync
        self.tag = dict(tag or {})
        self.events_written = 0
        self.commits = 0
        self.path.parent.mkdir(parents=True, exist_ok=True)
        valid = self.path.exists() and _header_ok(self.path)
        events = read_events(self.path) if valid else []
        self.seq = (events[-1]["seq"] + 1) if events else 0
        # corrupt/alien header: cold start (truncate)
        self._f = open(self.path, "a" if valid else "w", encoding="utf-8")
        if not valid:
            self._f.write(json.dumps(
                {"version": SCHEMA_VERSION, "kind": JOURNAL_KIND}) + "\n")
            self.commit()

    def append(self, ev: dict) -> int:
        """Buffer one event; returns its assigned seq. Not durable until
        the next `commit()`."""
        if ev.get("ev") not in EVENTS:
            raise ValueError(f"unknown journal event {ev.get('ev')!r}; "
                             f"expected one of {EVENTS}")
        seq = self.seq
        self._f.write(json.dumps({"seq": seq, **self.tag, **ev}) + "\n")
        self.seq += 1
        self.events_written += 1
        return seq

    def flush(self) -> None:
        """Push buffered events to the OS without fsync and without
        advancing the commit counter — durable against process death
        (page cache survives a SIGKILL), not against power loss. The
        next `commit()` covers these events with its fsync policy."""
        self._f.flush()

    def commit(self, *, force: bool = False) -> None:
        """Flush buffered events to the OS; fsync per the journal's
        `fsync` mode (`force=True` always syncs — graceful close)."""
        self._f.flush()
        self.commits += 1
        if self.fsync is True or force and self.fsync:
            os.fsync(self._f.fileno())
        elif (isinstance(self.fsync, int) and self.fsync > 0
                and self.commits % self.fsync == 0):
            os.fsync(self._f.fileno())

    @property
    def bytes_written(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        with contextlib.suppress(ValueError, OSError):
            self.commit(force=True)
        self._f.close()

    def compact(self, events: Iterable[dict]) -> None:
        """Atomically rewrite the journal with `events` (tmp + rename),
        e.g. after a snapshot makes the prefix redundant."""
        self.close()
        fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                   prefix=self.path.name + ".")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(json.dumps({"version": SCHEMA_VERSION,
                                    "kind": JOURNAL_KIND}) + "\n")
                for ev in events:
                    f.write(json.dumps(ev) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        self._f = open(self.path, "a", encoding="utf-8")


def _header_ok(path: Path) -> bool:
    try:
        with open(path, encoding="utf-8") as f:
            header = json.loads(f.readline())
    except (OSError, json.JSONDecodeError):
        return False
    return (isinstance(header, dict)
            and header.get("version") == SCHEMA_VERSION
            and header.get("kind") == JOURNAL_KIND)


def read_events(path: str | os.PathLike) -> list[dict]:
    """Read every durable event from a journal file.

    Tolerant by design: a missing file, a corrupt/alien header, or a
    torn final line (process killed mid-write) never raises. A torn or
    corrupt line *ends* the read — everything after an unacknowledged
    write is garbage by definition.
    """
    p = Path(path)
    if not p.exists():
        return []
    try:
        raw = p.read_text(encoding="utf-8")
    except OSError:
        return []
    lines = raw.split("\n")
    if not lines:
        return []
    try:
        header = json.loads(lines[0])
        if (header.get("version") != SCHEMA_VERSION
                or header.get("kind") != JOURNAL_KIND):
            return []
    except (json.JSONDecodeError, AttributeError):
        return []
    out: list[dict] = []
    expect: int | None = None           # a compacted log may start past 0
    for line in lines[1:]:
        if not line.strip():
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            break                       # torn tail: end of the durable log
        if not isinstance(ev, dict) or not isinstance(ev.get("seq"), int):
            break
        if expect is not None and ev["seq"] != expect:
            break                       # out-of-sequence: end of the log
        out.append(ev)
        expect = ev["seq"] + 1
    return out


@dataclasses.dataclass
class ReplayedRequest:
    """Everything the journal knows about one request."""
    rid: int
    prompt: list[int] | None = None
    max_new: int = 0
    klass: str = "throughput"
    deadline_s: float | None = None
    committed: list[int] = dataclasses.field(default_factory=list)
    status: str | None = None           # None = in flight at the crash
    reason: str | None = None
    submit_seq: int | None = None
    admit_seq: int | None = None        # last admit (re-admits overwrite)
    finish_seq: int | None = None
    slot: int | None = None
    group: int | None = None            # serving group (sharded sessions;
    #   None on untagged single-group journals)


@dataclasses.dataclass
class ReplaySummary:
    """Pure fold of a journal's event stream."""
    requests: dict[int, ReplayedRequest] = dataclasses.field(
        default_factory=dict)
    snapshots: list[tuple[int, int]] = dataclasses.field(
        default_factory=list)       # (seq, step)
    restores: int = 0
    last_seq: int = -1

    def committed_counts(self) -> dict[int, int]:
        return {rid: len(r.committed) for rid, r in self.requests.items()}


def replay(events: Iterable[dict]) -> ReplaySummary:
    """Fold an event stream into per-request committed outputs and
    terminal statuses. Pure and deterministic: replay(replay-input) of
    the same list always yields the same summary (idempotence is tested
    property-style)."""
    s = ReplaySummary()
    for ev in events:
        seq = int(ev.get("seq", -1))
        s.last_seq = max(s.last_seq, seq)
        kind = ev.get("ev")
        if kind == "snapshot":
            s.snapshots.append((seq, int(ev["step"])))
            continue
        if kind == "restore":
            s.restores += 1
            continue
        rid = int(ev["rid"])
        r = s.requests.setdefault(rid, ReplayedRequest(rid=rid))
        if "group" in ev:
            r.group = int(ev["group"])
        if kind == "submit":
            r.prompt = [int(t) for t in ev["prompt"]]
            r.max_new = int(ev["max_new"])
            r.klass = str(ev.get("klass", "throughput"))
            r.deadline_s = ev.get("deadline_s")
            r.submit_seq = seq
        elif kind == "admit":
            r.admit_seq = seq
            r.slot = int(ev["slot"])
        elif kind == "commit":
            r.committed.extend(int(t) for t in ev["tokens"])
        elif kind == "finish":
            status = str(ev["status"])
            if status not in FINISH_STATUSES:
                raise ValueError(f"unknown finish status {status!r}")
            r.status = status
            r.reason = ev.get("reason")
            r.finish_seq = seq
    return s
