"""Append-only, checksummed, seq-numbered ingest journal.

The port of ``repro.replica.journal``: the same appends write the same
file, byte for byte, and each package's ``scan_journal`` reads the other's
files, torn tails included.  Host code only (numpy and the port's
``transport.wire``).

Every ADD batch the coordinator accepts is journalled BEFORE it scatters to
the shard plane, so a replica that died mid-traffic can be rebuilt without
re-signing the corpus: boot it from the last directory snapshot (or
empty), then replay the journal tail.  Slicing each recorded batch through
the plane's partitioner reproduces the exact per-shard insertion sequence
the live replicas saw, hence a bit-identical signature buffer (checked by
``SketchStore.digest`` before the replica rejoins).

Records are wire frames (``transport.wire``): one ``MsgType.ADD`` frame a
record, CRC-32 checksummed, carrying

    seq     record sequence number (monotone from 0; authoritative: the
            16-byte header's uint32 seq is just its low bits)
    gid0    the coordinator's ``n_items`` when the batch was accepted (the
            global id of the batch's first row), which makes replay
            deterministic: ``owner = partitioner(gid0 + arange(B))``
    rows    (B, K) int32 raw signatures, OR
    words   (B, W) uint32 packed words (the fused-ingest path)

Durability: ``append`` writes one complete frame and flushes it
(``fsync=True`` adds an fsync a record).  A crash mid-append leaves a torn
tail; opening the journal recovers every complete record, truncates the
torn bytes and reports where they began (``torn_offset``, and the
``journal.torn_recoveries`` counter).  A batch whose scatter provably
landed nowhere is rolled back (``rollback``), so the journal never replays
a batch the coordinator's gid maps never saw.

Lifecycle: append -> snapshot -> truncate.  After a plane snapshot covers
records through seq S (``ReplicatedSketchStore.save`` records S beside the
manifest), ``truncate_through(S)`` drops the covered prefix.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..obs import metrics as obs_metrics
from ..transport import wire
from ..transport.wire import Message, MsgType


@dataclasses.dataclass
class JournalRecord:
    """One complete journalled ADD batch."""

    seq: int                  # record sequence number (monotone from 0)
    gid0: int                 # coordinator n_items when the batch landed
    packed: bool              # words (packed) vs rows (raw signatures)
    batch: np.ndarray         # (B, W) uint32 or (B, K) int32
    offset: int               # byte offset of the record's frame
    end: int                  # byte offset one past the frame


def scan_journal(path: str) -> tuple[list[JournalRecord], int, int | None]:
    """Read every complete record out of a journal file.

    Returns ``(records, end_offset, torn_offset)``: ``end_offset`` is one
    past the last complete record; ``torn_offset`` is where a torn or
    corrupt tail begins (None for a clean file).  A record cut mid-frame,
    or corrupted so its header or CRC no longer validates, ends the scan
    there: framing is lost beyond it.
    """
    with open(path, "rb") as f:
        data = f.read()
    mv = memoryview(data)
    records: list[JournalRecord] = []
    off, n = 0, len(data)
    while off < n:
        if off + wire.HEADER_SIZE > n:
            return records, off, off            # torn mid-header
        try:
            mtype, _, length, _ = wire.decode_header(
                data[off: off + wire.HEADER_SIZE])
        except wire.WireError:
            return records, off, off            # corrupt header
        end = off + wire.HEADER_SIZE + length
        if end > n:
            return records, off, off            # torn mid-payload
        try:
            msg = wire.decode_frame(mv[off:end])
        except wire.WireError:
            return records, off, off            # payload CRC / decode fail
        f_ = msg.fields
        if msg.type != MsgType.ADD or "seq" not in f_ or "gid0" not in f_ \
                or not ("rows" in f_ or "words" in f_):
            return records, off, off            # not a journal record
        packed = "words" in f_
        # copy out of the file buffer so records outlive the scan
        batch = np.array(f_["words"] if packed else f_["rows"])
        records.append(JournalRecord(int(f_["seq"]), int(f_["gid0"]),
                                     packed, batch, off, end))
        off = end
    return records, off, None


def _record_frame(seq: int, gid0: int, batch: np.ndarray,
                  *, packed: bool) -> bytes:
    key = "words" if packed else "rows"
    arr = np.ascontiguousarray(batch, np.uint32 if packed else np.int32)
    return wire.message_bytes(Message(MsgType.ADD,
                                      {"seq": int(seq), "gid0": int(gid0),
                                       key: arr},
                                      seq=seq & 0xFFFFFFFF))


class IngestJournal:
    """The coordinator's write-ahead record of every accepted ADD batch.

    One writer (the coordinator's scatter, serialized under the plane
    lock); readers (``records``, the supervisor's replay) re-open the file
    each pass and see only complete flushed frames.
    """

    def __init__(self, path: str, *, fsync: bool = False):
        self.path = str(path)
        self.fsync = fsync
        reg = obs_metrics.default()
        self._m_appends = reg.counter("journal.appends")
        self._m_rollbacks = reg.counter("journal.rollbacks")
        self._m_torn = reg.counter("journal.torn_recoveries")
        self._m_bytes = reg.counter("journal.bytes")
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.torn_offset: int | None = None
        if os.path.exists(self.path):
            records, end, torn = scan_journal(self.path)
            if torn is not None:
                # crash mid-append: keep every complete record, drop the
                # torn bytes so the next append starts frame-aligned
                self.torn_offset = torn
                self._m_torn.inc()
                with open(self.path, "r+b") as f:
                    f.truncate(torn)
                end = torn
            self.next_seq = records[-1].seq + 1 if records else 0
            self._end = end
        else:
            self.next_seq = 0
            self._end = 0
        self._f = open(self.path, "ab")
        self._last_off: int | None = None      # offset of the last append

    @property
    def last_seq(self) -> int:
        """Seq of the most recent record (-1 for an empty journal)."""
        return self.next_seq - 1

    def append(self, batch: np.ndarray, *, packed: bool, gid0: int) -> int:
        """Journal one ADD batch; returns the record's byte offset (the
        rollback token).  The frame is flushed before this returns, so a
        reader never sees a partial record from a live writer."""
        frame = _record_frame(self.next_seq, gid0, batch, packed=packed)
        off = self._end
        self._f.write(frame)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._end += len(frame)
        self._last_off = off
        self.next_seq += 1
        self._m_appends.inc()
        self._m_bytes.inc(len(frame))
        return off

    def rollback(self, offset: int) -> None:
        """Undo the LAST append (truncate back to its offset), for a batch
        whose scatter provably landed on no shard: replaying it would
        diverge a resynced replica from its peers."""
        if offset != self._last_off:
            raise ValueError(
                f"rollback offset {offset} is not the last append "
                f"({self._last_off}); only the most recent record can be "
                "rolled back")
        self._f.flush()
        self._f.truncate(offset)
        self._end = offset
        self._last_off = None
        self.next_seq -= 1
        self._m_rollbacks.inc()

    def records(self, *, after: int = -1) -> list[JournalRecord]:
        """Every complete record with ``seq > after`` (a fresh read of the
        file, safe against the live writer, which flushes whole frames)."""
        if not os.path.exists(self.path):
            return []
        records, _, _ = scan_journal(self.path)
        return [r for r in records if r.seq > after]

    def truncate_through(self, seq: int) -> int:
        """Drop records with ``seq <= seq`` (a plane snapshot covers them):
        the survivors are rewritten to a temporary file that atomically
        replaces the journal.  Returns the number of records dropped."""
        if not os.path.exists(self.path):
            return 0
        with open(self.path, "rb") as f:
            data = f.read()
        records, _, _ = scan_journal(self.path)
        keep = [r for r in records if r.seq > seq]
        dropped = len(records) - len(keep)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for r in keep:
                f.write(data[r.offset: r.end])
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        self._end = os.path.getsize(self.path)
        self._last_off = None
        return dropped

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    def __enter__(self) -> "IngestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
