"""Append-only write-ahead log: the durable source of truth.

Plays the role CockroachDB plays in the reference (the DAR snapshot is
a cache rebuilt from it; see SURVEY.md §5 checkpoint/resume).  Records
are JSON lines {"seq": n, "t": type, ...}; replay applies them in order
to rebuild store state.  fsync per append is configurable (off by
default: group-commit style durability is the deployment's call, like
the reference's reliance on CRDB commit semantics).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Iterator, Optional

from dss_tpu_torch.chaos import fault_point

# Log format version.  A head record {"t": "__format__", "version": N}
# gates boot: replaying a log written by an incompatible future format
# must refuse loudly instead of rebuilding garbage state — the
# reference's schema gate (MustSupportSchema,
# the upstream DSS's cmds/grpc-backend/main.go:75-86,
# pkg/rid/cockroach/store.go:165-187).  Logs predating versioning
# (no head record) read as version 0, which is compatible.
FORMAT_VERSION = 1
FORMAT_RECORD_TYPE = "__format__"


class LogFormatError(RuntimeError):
    """The log was written by an unsupported (newer) format."""


class LogCorruptError(RuntimeError):
    """The log has an undecodable region FOLLOWED by valid records —
    mid-log corruption (bit rot, partial page write), not a crash-torn
    tail.  Truncating here would silently delete fsync-acked records,
    so boot refuses instead; the file is left byte-for-byte intact for
    repair/forensics (the quarantine).  Operators repair or move the
    file aside explicitly to proceed."""


def format_record() -> dict:
    return {"t": FORMAT_RECORD_TYPE, "version": FORMAT_VERSION}


def check_format_record(rec: Optional[dict], path: str) -> None:
    """Raise LogFormatError if the head record declares an unsupported
    version.  rec=None (legacy headerless log) is accepted."""
    if rec is None or rec.get("t") != FORMAT_RECORD_TYPE:
        return
    v = rec.get("version", 0)
    if not isinstance(v, int) or v > FORMAT_VERSION:
        raise LogFormatError(
            f"log {path} has format version {v}, but this binary "
            f"supports <= {FORMAT_VERSION}; refusing to start "
            "(upgrade the binary or restore a compatible log)"
        )


class WriteAheadLog:
    def __init__(self, path: Optional[str], fsync: bool = False):
        """path=None -> disabled (in-memory deployments / tests)."""
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        self._seq = 0
        self._fh = None
        # True when boot recovery truncated a torn tail: with fsync
        # off, acked records may have been lost with the tear, so the
        # log's history is no longer guaranteed to be a superset of
        # what readers saw.  The region log rotates its persisted
        # epoch on this signal (and ONLY this signal or promotion) so
        # clean restarts no longer fence every writer.
        self.recovered_truncation = False
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            if os.path.exists(path) and os.path.getsize(path) > 0:
                # one recovery pass: format gate + seq recovery + the
                # valid-prefix length.  A crash can leave a torn final
                # line; appending after it would MERGE the next record
                # into one garbage line that a later replay drops
                # (silent loss of that write and everything after it),
                # so truncate to the last complete record first.
                # Truncation is ONLY legal when the invalid region
                # extends to EOF (a true crash tear): valid records
                # after an undecodable line mean mid-log corruption,
                # and deleting them would be silent loss of
                # fsync-acked writes — refuse to start instead.
                valid, self._seq = self._recover(path)
                if valid < os.path.getsize(path):
                    if self._valid_records_after(path, valid):
                        raise LogCorruptError(
                            f"log {path} is corrupt at byte {valid}: "
                            "valid records exist after an undecodable "
                            "region (mid-log corruption, not a crash "
                            "tear).  Refusing to truncate acked "
                            "records; repair the file or move it "
                            "aside to proceed."
                        )
                    with open(path, "r+b") as fh:
                        fh.truncate(valid)
                    self.recovered_truncation = True
            # re-stat AFTER truncation: a fully-torn header line must
            # count as a fresh log and get a fresh format header
            fresh = os.path.getsize(path) == 0 if os.path.exists(
                path
            ) else True
            self._fh = open(path, "a", encoding="utf-8")
            if fresh:
                # header carries no seq: user records stay 1-based
                self._fh.write(
                    json.dumps(format_record(), separators=(",", ":"))
                    + "\n"
                )
                self._fh.flush()

    @staticmethod
    def _recover(path: str) -> tuple:
        """-> (valid prefix bytes, max seq) in ONE pass, mirroring
        replay()'s tolerance exactly (blank lines pass; the first
        undecodable or newline-less line ends the prefix).  Applies
        the head format gate — an unsupported log version raises
        LogFormatError here, refusing boot."""
        valid = 0
        seq = 0
        first = True
        with open(path, "rb") as fh:
            while True:
                line = fh.readline()
                if not line:
                    break
                if not line.endswith(b"\n"):
                    break  # torn tail (no newline): not complete
                stripped = line.strip()
                if stripped:
                    try:
                        rec = json.loads(stripped)
                    except ValueError:
                        # JSONDecodeError, or UnicodeDecodeError from
                        # json's encoding sniff on rotted bytes (e.g.
                        # NUL runs look like UTF-32) — both ValueError
                        break
                    if not isinstance(rec, dict):
                        break  # rot that decodes as a JSON scalar
                    if first:
                        first = False
                        check_format_record(rec, path)
                    seq = max(seq, rec.get("seq", 0))
                valid = fh.tell()
        return valid, seq

    @staticmethod
    def _valid_records_after(path: str, offset: int) -> bool:
        """True when any complete, decodable JSON record line exists
        AFTER the undecodable line at `offset` — the mid-log-corruption
        discriminator.  A torn tail (the common crash shape) has
        nothing decodable after it; bit rot in the middle does."""
        with open(path, "rb") as fh:
            fh.seek(offset)
            bad = fh.readline()
            if not bad.endswith(b"\n"):
                return False  # the bad region runs to EOF: a tear
            while True:
                line = fh.readline()
                if not line:
                    return False
                if not line.endswith(b"\n"):
                    return False  # only a torn tail remains
                stripped = line.strip()
                if not stripped:
                    continue
                try:
                    rec = json.loads(stripped)
                except ValueError:  # undecodable bytes or bad JSON
                    continue  # more damage; keep scanning
                if isinstance(rec, dict):
                    return True

    @property
    def seq(self) -> int:
        """Last assigned sequence number (leader-side freshness stamp)."""
        return self._seq

    def append(self, record: dict) -> int:
        with self._lock:
            # chaos seam BEFORE the seq assignment/write: an injected
            # append error leaves no half-recorded state, and a delay
            # models a slow disk stalling the writer
            fault_point("wal.append")
            self._seq += 1
            record = dict(record, seq=self._seq)
            if self._fh is not None:
                self._fh.write(json.dumps(record, separators=(",", ":")) + "\n")
                self._fh.flush()
                if self.fsync:
                    fault_point("wal.fsync")
                    os.fsync(self._fh.fileno())
            return self._seq

    def sync(self) -> None:
        """fsync the log regardless of the per-append fsync setting —
        for rare, must-survive records (epoch rotations) on deployments
        that run with fsync off for throughput."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                fault_point("wal.fsync")
                os.fsync(self._fh.fileno())

    def replay(self) -> Iterator[dict]:
        """Yield records in order; tolerates a torn final line.  Raises
        LogFormatError if the head record declares an unsupported
        format (the boot gate)."""
        if self.path is None or not os.path.exists(self.path):
            return
        first = True
        with open(self.path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # torn tail write (crash mid-append): stop replay here
                    return
                if not isinstance(rec, dict):
                    return  # same: not a complete record
                if first:
                    first = False
                    check_format_record(rec, self.path)
                if rec.get("t") == FORMAT_RECORD_TYPE:
                    continue  # gate metadata, not store state
                yield rec

    def adopt(self, tmp_path: str, seq: int) -> None:
        """Swap a fully-written, fsynced replacement log into place:
        rename over the old log and reopen for append.  The caller
        guarantees no append races the swap (e.g. by staging the swap
        on the thread that owns all appends)."""
        if self.path is None:
            return
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            os.replace(tmp_path, self.path)
            self._seq = seq
            self._fh = open(self.path, "a", encoding="utf-8")

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
