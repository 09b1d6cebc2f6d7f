"""Event-sourced state journal for the control daemon.

Every state-changing message the daemon accepts (Reserve / Register /
SendState / Tick / ...) is appended here *with the clock instant it was
handled at*, before it executes — a classic write-ahead log. The daemon is
deterministic given that sequence (token counters, epoch ids,
``build_calendar``, policy arithmetic are all pure functions of message
order), so replaying the journal through a fresh daemon reproduces
byte-identical calendar state: restart is a *scenario*, not an outage
(``ControlDaemon.recover``; exercised by simnet's ``cp_restart``).

Persistence follows ``checkpoint/ckpt.py``'s idioms: JSONL for the live
append path (one flushed line per entry — a torn final line is detected and
dropped on load, never replayed corrupt), and snapshots written to
``snap_<seq>/`` directories with a ``manifest.json`` and an atomic
tmp-then-rename so a killed snapshot never corrupts the restore source.
``restore`` = latest snapshot + any newer live-tail entries.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import IO, Iterable, Optional


@dataclasses.dataclass(frozen=True)
class Entry:
    seq: int
    kind: str
    payload: dict  # message fields + "now" (the clock instant handled at)

    def to_line(self) -> str:
        return json.dumps({"seq": self.seq, "kind": self.kind,
                           "payload": self.payload},
                          sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_line(cls, line: str) -> "Entry":
        d = json.loads(line)
        return cls(seq=int(d["seq"]), kind=str(d["kind"]),
                   payload=dict(d["payload"]))


class Journal:
    """Append-only entry log: in memory, on disk (JSONL), or both.

    An in-memory journal (``path=None``) retains every entry in ``entries``
    — it IS the replay source. A file-backed journal relies on the disk
    copy instead (``retain=False``): a long-running daemon's memory stays
    bounded no matter how many heartbeats it journals, and recovery reads
    the file back (``load``).

    **Auto-compaction** (``snapshot_dir`` + ``compact_every``): every N
    appends the journal rolls its WAL into a snapshot — the full history
    (previous snapshot + live tail) lands atomically under
    ``snapshot_dir/snap_<seq>/`` and the live file is truncated, so the WAL
    stays bounded by N entries no matter how long the daemon runs. Recovery
    for a compacted journal is ``Journal.restore(snapshot_dir,
    tail_path=path)`` (+ ``Journal.resume`` to keep appending); a bare
    ``load(path)`` only sees the tail."""

    def __init__(self, path: Optional[str] = None,
                 retain: Optional[bool] = None,
                 snapshot_dir: Optional[str] = None,
                 compact_every: int = 0):
        self.path = path
        self.retain = (path is None) if retain is None else retain
        self.snapshot_dir = snapshot_dir
        self.compact_every = int(compact_every)
        self.entries: list[Entry] = []
        self._seq = -1
        self._since_compact = 0
        self._compacted = False  # the live file no longer holds seq 0..
        self._fh: Optional[IO[str]] = None
        #: observer called with each freshly appended Entry — the HA
        #: leader's replication tap (``controld.ha``). Never fired by
        #: ``append_entry`` (a standby applying *shipped* entries) or
        #: ``adopt`` (recovery).
        self.on_append = None
        #: optional ``testing.faults.FaultInjector`` — threads named
        #: crash points through every write/rename step below
        self.faults = None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", encoding="utf-8")

    @property
    def seq(self) -> int:
        """Sequence number of the last entry (-1 when empty)."""
        return self._seq

    def _fault(self, point: str) -> None:
        if self.faults is not None:
            self.faults.crashpoint(point)

    def _write_line(self, e: Entry) -> None:
        """One flushed JSONL line, with torn-write injection: a scheduled
        tear writes only a prefix of the line (a process killed inside
        ``write(2)``) and then crashes."""
        line = e.to_line() + "\n"
        if self.faults is not None:
            self._fault("journal.append.write")
            torn = self.faults.torn_bytes("journal.append.write",
                                          line.encode())
            if torn is not None:
                from repro_torch.testing.faults import InjectedCrash
                self._fh.write(torn.decode("utf-8", "ignore"))
                self._fh.flush()
                raise InjectedCrash("injected torn write at "
                                    "journal.append.write")
        self._fh.write(line)
        self._fault("journal.append.flush")
        self._fh.flush()

    def append(self, kind: str, payload: dict) -> Entry:
        e = Entry(seq=self._seq + 1, kind=kind, payload=payload)
        self._seq = e.seq
        if self.retain:
            self.entries.append(e)
        if self._fh is not None:
            self._write_line(e)
            if self.compact_every and self.snapshot_dir is not None:
                self._since_compact += 1
                if self._since_compact >= self.compact_every:
                    self.compact()
        if self.on_append is not None:
            self.on_append(e)
        return e

    def append_entry(self, e: Entry) -> Entry:
        """Append an already-sequenced entry (a replicated WAL shipment):
        the standby's journal must mirror the leader's byte-for-byte, so
        the entry keeps its seq/payload exactly. Contiguity is enforced;
        ``on_append`` is NOT fired (shipped entries must not re-ship)."""
        if e.seq != self._seq + 1:
            raise ValueError(
                f"non-contiguous replicated seq {e.seq} (at {self._seq})")
        self._seq = e.seq
        if self.retain:
            self.entries.append(e)
        if self._fh is not None:
            self._write_line(e)
            if self.compact_every and self.snapshot_dir is not None:
                self._since_compact += 1
                if self._since_compact >= self.compact_every:
                    self.compact()
        return e

    def adopt(self, entries: Iterable[Entry]) -> None:
        """Install an already-replayed history as this journal's prefix (the
        recovered daemon keeps journaling *after* it, seq-contiguous). Only
        valid on an empty journal."""
        if self._seq != -1 or self.entries:
            raise ValueError("adopt() requires an empty journal")
        for e in entries:
            if e.seq != self._seq + 1:
                raise ValueError(f"non-contiguous journal seq {e.seq}")
            self._seq = e.seq
            if self.retain:
                self.entries.append(e)
            if self._fh is not None:
                self._fh.write(e.to_line() + "\n")
        if self._fh is not None:
            self._fh.flush()

    def release_replayed(self) -> None:
        """Drop the in-RAM entry list once it has been replayed, for
        journals whose durable copy lives on disk (``retain=False``)."""
        if not self.retain:
            self.entries = []

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def read_entries(self, from_seq: int = 0) -> list[Entry]:
        """Entries with ``seq >= from_seq`` — the HA leader's backlog
        source when a standby (re)attaches behind the log head. Retained
        journals slice memory; file-backed journals read the live file
        back, plus the latest snapshot when compaction moved the prefix
        out of it."""
        if self.retain:
            return [e for e in self.entries if e.seq >= from_seq]
        if self.path is None:
            return []
        if self._fh is not None:
            self._fh.flush()
        out: list[Entry] = []
        if self._compacted and self.snapshot_dir is not None:
            snap = self.latest_snapshot(self.snapshot_dir)
            if snap is not None:
                with open(os.path.join(snap, "entries.jsonl"),
                          encoding="utf-8") as f:
                    for line in f:
                        if line.strip():
                            e = Entry.from_line(line)
                            if e.seq >= from_seq:
                                out.append(e)
        floor = out[-1].seq if out else from_seq - 1
        if os.path.exists(self.path):
            with open(self.path, encoding="utf-8") as f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        e = Entry.from_line(line)
                    except (json.JSONDecodeError, KeyError, ValueError):
                        break  # torn live tail: nothing after it is usable
                    if e.seq > floor:
                        out.append(e)
                        floor = e.seq
        return out

    # -- load / snapshot / restore -------------------------------------------
    @classmethod
    def load(cls, path: str, faults=None) -> "Journal":
        """Read a JSONL journal back (for recovery). A torn final line —
        a daemon killed mid-append — is dropped, not replayed corrupt.
        The loaded ``entries`` are there to be replayed once (recover()
        releases them afterwards; the file stays the durable copy)."""
        j = cls(path=None)
        j.faults = faults
        torn = False
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                lines = f.read().splitlines()
            for i, line in enumerate(lines):
                if not line.strip():
                    continue
                try:
                    j.entries.append(Entry.from_line(line))
                except (json.JSONDecodeError, KeyError, ValueError):
                    if i == len(lines) - 1:
                        torn = True
                        break  # torn tail from a mid-append kill
                    raise
        if torn:
            # rewrite without the partial line so future appends stay
            # valid — via tmp + atomic replace: a kill *during* the
            # rewrite must not take the good prefix down with the torn
            # tail (found by the crash-point sweep in tests/test_faults)
            tmp = path + ".rewrite.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for e in j.entries:
                    f.write(e.to_line() + "\n")
            if faults is not None:
                faults.crashpoint("journal.load.rewrite")
            os.replace(tmp, path)
        j._seq = j.entries[-1].seq if j.entries else -1
        j.path = path
        j.retain = False  # from here on the file is the source of truth
        j._fh = open(path, "a", encoding="utf-8")
        return j

    def snapshot(self, directory: str) -> str:
        """Atomic snapshot of the full entry history up to ``seq`` (ckpt.py
        idiom: write to ``.tmp``, manifest last, one ``os.rename``).

        Idempotent per seq: if ``snap_<seq+1>`` already exists it is
        complete (it can only appear via the final rename) and holds the
        identical append-only history, so it is returned as-is — the old
        rmtree-then-rename left a window where a kill destroyed the only
        good snapshot (found by the crash-point sweep)."""
        final = os.path.join(directory, f"snap_{self.seq + 1:08d}")
        if os.path.exists(final):
            return final
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        self._fault("journal.snapshot.start")
        if not self.retain and self.path is not None:
            # disk is the source of truth for a file-backed journal; after
            # a compaction the history is split between the latest snapshot
            # (the prefix) and the live file (the tail)
            if self._fh is not None:
                self._fh.flush()
            dst = os.path.join(tmp, "entries.jsonl")
            prev = (self.latest_snapshot(self.snapshot_dir)
                    if self._compacted and self.snapshot_dir else None)
            if prev is None:
                shutil.copyfile(self.path, dst)
            else:
                # concat prefix snapshot + live tail, dropping tail lines
                # whose seq the prefix already covers: a tail that still
                # holds pre-compaction entries (e.g. a kill between
                # snapshot and truncate, then Journal.resume) must not
                # snapshot the same seq twice (double-applied compaction,
                # found by the crash-point sweep)
                with open(os.path.join(prev, "manifest.json")) as f:
                    prev_seq = int(json.load(f)["seq"])
                with open(dst, "w", encoding="utf-8") as out:
                    with open(os.path.join(prev, "entries.jsonl"),
                              encoding="utf-8") as f:
                        shutil.copyfileobj(f, out)
                    with open(self.path, encoding="utf-8") as f:
                        for line in f:
                            if (line.strip() and
                                    Entry.from_line(line).seq > prev_seq):
                                out.write(line)
        else:
            with open(os.path.join(tmp, "entries.jsonl"), "w",
                      encoding="utf-8") as f:
                for e in self.entries:
                    f.write(e.to_line() + "\n")
        self._fault("journal.snapshot.entries")
        manifest = {"seq": self.seq, "n_entries": self.seq + 1,
                    "time": time.time()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        self._fault("journal.snapshot.manifest")
        os.rename(tmp, final)
        self._fault("journal.snapshot.rename")
        return final

    def compact(self) -> str:
        """Roll the WAL: write a full-history snapshot under
        ``snapshot_dir``, then truncate the live file — the snapshot is now
        the durable prefix and the file only accumulates the newer tail.
        Recovery: ``restore(snapshot_dir, tail_path=path)``; resume
        appending with ``Journal.resume(path, seq, ...)``."""
        if self.path is None or self._fh is None:
            raise ValueError("compact() requires a file-backed journal")
        if self.snapshot_dir is None:
            raise ValueError("compact() requires snapshot_dir")
        final = self.snapshot(self.snapshot_dir)
        self._fault("journal.compact.snapshotted")
        self._fh.close()
        self._fh = open(self.path, "w", encoding="utf-8")  # truncate
        self._fault("journal.compact.truncated")
        self._compacted = True
        self._since_compact = 0
        return final

    @classmethod
    def resume(cls, path: str, base_seq: int,
               snapshot_dir: Optional[str] = None,
               compact_every: int = 0) -> "Journal":
        """Continue a compacted WAL at ``base_seq`` without rewriting the
        replayed history into it: the snapshot under ``snapshot_dir`` holds
        the prefix, ``path`` holds (and keeps accumulating) the tail. Hand
        this to ``ControlDaemon.recover(..., live_journal=...)``."""
        j = cls(path=path, retain=False, snapshot_dir=snapshot_dir,
                compact_every=compact_every)
        j._seq = int(base_seq)
        j._compacted = True
        return j

    @staticmethod
    def latest_snapshot(directory: str) -> Optional[str]:
        if not os.path.isdir(directory):
            return None
        snaps = [d for d in os.listdir(directory)
                 if d.startswith("snap_") and not d.endswith(".tmp")]
        if not snaps:
            return None
        return os.path.join(directory, max(snaps,
                                           key=lambda d: int(d.split("_")[1])))

    @classmethod
    def restore(cls, directory: str,
                tail_path: Optional[str] = None) -> "Journal":
        """Latest snapshot under ``directory`` plus any live-tail entries in
        ``tail_path`` with a newer seq. Returns an in-memory journal ready
        for ``ControlDaemon.recover``."""
        snap = cls.latest_snapshot(directory)
        if snap is None:
            raise FileNotFoundError(f"no snapshots under {directory}")
        with open(os.path.join(snap, "manifest.json")) as f:
            manifest = json.load(f)
        j = cls(path=None)
        with open(os.path.join(snap, "entries.jsonl"), encoding="utf-8") as f:
            for line in f.read().splitlines():
                if line.strip():
                    j.entries.append(Entry.from_line(line))
        j._seq = j.entries[-1].seq if j.entries else -1
        if j.seq != manifest["seq"]:
            raise ValueError(
                f"snapshot {snap} inconsistent: manifest seq "
                f"{manifest['seq']} vs entries {j.seq}")
        if tail_path is not None and os.path.exists(tail_path):
            tail = cls.load(tail_path)
            tail.close()
            for e in tail.entries:
                if e.seq > j.seq:
                    j.entries.append(e)
                    j._seq = e.seq
        return j
