"""The port's ingest journal against the JAX package's, on the CPU.

``repro_torch.replica.journal`` is held to the reference's journal byte for
byte: the same appends (raw int32 rows or packed uint32 words, zero-row
batches included) give the same file, rollbacks and ``truncate_through``
leave the same file, and each package's ``scan_journal`` reads the other's
files with the same records, end offset and torn offset, at every cut of
a torn tail and after a corrupted byte.  The cases mirror
``tests/test_journal.py``; its hypothesis fuzz case is a seeded numpy
sweep here, one counted case for each record kind, width and zero-row
setting (tolerance 0 throughout: bytes and integers).
"""

import os

import numpy as np
import pytest

from repro.replica import IngestJournal as RefJournal
from repro.replica import scan_journal as ref_scan
from repro.replica.journal import _record_frame as ref_record_frame
from repro.transport import wire as ref_wire
from repro_torch.replica import IngestJournal, scan_journal
from repro_torch.replica.journal import _record_frame
from repro_torch.transport import wire


def _random_batch(rng: np.random.Generator, packed: bool, n_rows: int,
                  width: int) -> np.ndarray:
    if packed:
        return rng.integers(0, 2**32, (n_rows, width), dtype=np.uint64) \
            .astype(np.uint32)
    return rng.integers(0, 2**31, (n_rows, width), dtype=np.int64) \
        .astype(np.int32)


def _key(records) -> list:
    """A record list as comparable tuples (both packages' records)."""
    return [(r.seq, r.gid0, r.packed, r.batch.dtype.str, r.batch.shape,
             r.batch.tobytes(), r.offset, r.end) for r in records]


def _scan_both(path: str):
    """Both packages' scans of one file; they must agree exactly."""
    mine, ref = scan_journal(path), ref_scan(path)
    assert _key(mine[0]) == _key(ref[0])
    assert mine[1:] == ref[1:]
    return mine


def _append_both(tmp_path, name: str, appends) -> tuple[str, str]:
    """The same appends through each package's journal; returns both
    paths, whose bytes must be equal."""
    paths = (str(tmp_path / f"{name}.port.journal"),
             str(tmp_path / f"{name}.ref.journal"))
    offsets = []
    for cls, path in zip((IngestJournal, RefJournal), paths):
        with cls(path) as j:
            offsets.append([j.append(b, packed=p, gid0=g)
                            for b, p, g in appends])
            assert j.last_seq == len(appends) - 1
    assert offsets[0] == offsets[1]
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    return paths


def _build(tmp_path, name: str, n: int = 3, seed: int = 7):
    rng = np.random.default_rng(seed)
    appends, gid0 = [], 0
    for i in range(n):
        packed = i % 2 == 1
        batch = _random_batch(rng, packed, 2 + i, 4)
        appends.append((batch, packed, gid0))
        gid0 += len(batch)
    return _append_both(tmp_path, name, appends), appends


# -- round trips: a seeded sweep ----------------------------------------------

@pytest.mark.parametrize("zero_rows", [False, True])
@pytest.mark.parametrize("width", [1, 4, 9])
@pytest.mark.parametrize("kind", ["rows", "words", "mixed"])
def test_roundtrip_sweep_byte_equal(tmp_path, kind, width, zero_rows):
    """Eight appends of one kind (or alternating), one width, with or
    without zero-row batches: both packages write the same bytes, read each
    other's file back bit-exactly and in seq order, clean, through a
    close and reopen, and ``records(after=)`` agrees."""
    seed = 100 * ("rows", "words", "mixed").index(kind) + 10 * width \
        + zero_rows
    rng = np.random.default_rng(seed)
    appends, gid0 = [], 0
    for i in range(8):
        packed = {"rows": False, "words": True, "mixed": i % 2 == 1}[kind]
        n_rows = 0 if zero_rows and i % 3 == 0 else int(rng.integers(1, 6))
        batch = _random_batch(rng, packed, n_rows, width)
        appends.append((batch, packed, gid0))
        gid0 += n_rows
    port_path, ref_path = _append_both(tmp_path, "sweep", appends)
    for path in (port_path, ref_path):
        records, end, torn = _scan_both(path)
        assert torn is None and end == os.path.getsize(path)
        assert len(records) == len(appends)
        for seq, (rec, (batch, packed, g0)) in enumerate(zip(records,
                                                             appends)):
            assert (rec.seq, rec.gid0, rec.packed) == (seq, g0, packed)
            assert rec.batch.dtype == batch.dtype
            assert np.array_equal(rec.batch, batch)
    for cls in (IngestJournal, RefJournal):
        for path in (port_path, ref_path):
            with cls(path) as j:
                assert j.torn_offset is None and j.last_seq == 7
                for after in (-1, 3, 7):
                    assert [r.seq for r in j.records(after=after)] == \
                        list(range(after + 1, 8))


# -- torn tails ------------------------------------------------------------------

def test_torn_tail_every_cut_offset(tmp_path):
    """Each package's file cut at EVERY byte offset inside its last record:
    both scans recover the two earlier batches bit-exactly and report the
    torn offset at the record's start."""
    (port_path, ref_path), appends = _build(tmp_path, "torn")
    for path in (port_path, ref_path):
        data = open(path, "rb").read()
        records, end, _ = _scan_both(path)
        last_start = records[-1].offset
        for cut in range(last_start + 1, end):
            p = str(tmp_path / f"cut_{cut}.journal")
            with open(p, "wb") as f:
                f.write(data[:cut])
            recs, clean_end, torn = _scan_both(p)
            assert torn == last_start and clean_end == last_start
            assert _key(recs) == _key(records[:2])


def test_open_truncates_torn_tail_and_resumes(tmp_path):
    """Opening a torn journal (either package's, by either package)
    recovers the complete records, reports the torn offset, truncates the
    garbage and appends frame-aligned, reusing the torn record's seq: the
    files stay byte-equal."""
    (port_path, ref_path), appends = _build(tmp_path, "resume")
    records, _, _ = _scan_both(port_path)
    cut = records[-1].offset + (records[-1].end - records[-1].offset) // 2
    nxt = _random_batch(np.random.default_rng(1), False, 3, 4)
    out = []
    for cls, path in ((IngestJournal, ref_path), (RefJournal, port_path)):
        with open(path, "r+b") as f:
            f.truncate(cut)
        j = cls(path)
        assert j.torn_offset == records[-1].offset
        assert j.last_seq == 1
        assert os.path.getsize(path) == records[-1].offset
        j.append(nxt, packed=False, gid0=appends[2][2])
        assert [r.seq for r in j.records()] == [0, 1, 2]
        j.close()
        out.append(open(path, "rb").read())
    assert out[0] == out[1]
    got = _scan_both(port_path)[0]
    assert np.array_equal(got[2].batch, nxt) and not got[2].packed


def test_corrupted_mid_file_stops_scan_at_corruption(tmp_path):
    """A flipped byte inside record 1 ends both scans there."""
    (port_path, _), _ = _build(tmp_path, "corrupt")
    records, _, _ = _scan_both(port_path)
    data = bytearray(open(port_path, "rb").read())
    data[records[1].offset + wire.HEADER_SIZE + 2] ^= 0xFF
    with open(port_path, "wb") as f:
        f.write(data)
    recs, end, torn = _scan_both(port_path)
    assert [r.seq for r in recs] == [0]
    assert torn == end == records[1].offset


# -- rollback and truncation ----------------------------------------------------

def test_rollback_removes_only_last_record(tmp_path):
    """Rollback of the last append, a refused rollback of an older offset,
    and a re-append: both packages leave the same bytes and a gapless seq
    space."""
    (port_path, ref_path), _ = _build(tmp_path, "rb", n=2)
    out = []
    for cls, path in ((IngestJournal, port_path), (RefJournal, ref_path)):
        j = cls(path)
        off = j.append(np.zeros((2, 4), np.int32), packed=False, gid0=99)
        j.rollback(off)
        assert j.last_seq == 1
        assert [r.seq for r in j.records()] == [0, 1]
        off2 = j.append(np.ones((1, 4), np.int32), packed=False, gid0=99)
        with pytest.raises(ValueError):
            j.rollback(off2 - 1)
        assert [r.seq for r in j.records()] == [0, 1, 2]
        j.close()
        out.append(open(path, "rb").read())
    assert out[0] == out[1]
    _scan_both(port_path)


def test_truncate_through_drops_snapshot_covered_prefix(tmp_path):
    """append -> snapshot -> truncate: both packages drop the same prefix,
    keep the survivors' seqs and bytes, append on, and leave equal
    files."""
    (port_path, ref_path), appends = _build(tmp_path, "trunc", n=4)
    out = []
    for cls, path in ((IngestJournal, port_path), (RefJournal, ref_path)):
        j = cls(path)
        assert j.truncate_through(1) == 2
        got = j.records()
        assert [r.seq for r in got] == [2, 3]
        for rec, (batch, packed, g0) in zip(got, appends[2:]):
            assert rec.gid0 == g0 and np.array_equal(rec.batch, batch)
        j.append(np.ones((1, 4), np.int32), packed=False, gid0=123)
        assert [r.seq for r in j.records()] == [2, 3, 4]
        assert j.truncate_through(-1) == 0
        j.close()
        out.append(open(path, "rb").read())
    assert out[0] == out[1]
    _scan_both(port_path)


def test_empty_and_zero_row_batches(tmp_path):
    """An empty journal opens clean at seq -1; a zero-row batch is a legal
    record, the same bytes in both packages."""
    paths = _append_both(tmp_path, "empty",
                         [(np.zeros((0, 8), np.uint32), True, 0)])
    for path in paths:
        records, _, torn = _scan_both(path)
        assert torn is None
        assert len(records) == 1 and records[0].batch.shape == (0, 8)
    with IngestJournal(str(tmp_path / "fresh.journal")) as j:
        assert j.last_seq == -1 and j.records() == []


def test_record_frame_is_wire_decodable():
    """Records are wire frames: the port's frame equals the reference's
    byte for byte and both packages' decoders read it."""
    rows = np.arange(12, dtype=np.int32).reshape(3, 4)
    frame = _record_frame(5, 40, rows, packed=False)
    assert frame == ref_record_frame(5, 40, rows, packed=False)
    words = np.arange(8, dtype=np.uint32).reshape(2, 4) + 2**31
    assert _record_frame(2**33 + 1, 7, words, packed=True) == \
        ref_record_frame(2**33 + 1, 7, words, packed=True)
    for decode in (wire.decode_frame, ref_wire.decode_frame):
        msg = decode(frame)
        assert int(msg.type) == int(wire.MsgType.ADD)
        assert int(msg["seq"]) == 5 and int(msg["gid0"]) == 40
        assert np.array_equal(msg["rows"], rows)
