"""Binary wire protocol for the shard transport plane.

Byte-compatible with ``repro.transport.wire``: the same magic, version,
message types, field encoding, dtype codes, crc and limits, so a frame
either package encodes the other decodes.  The wire carries numpy arrays;
tensors become numpy at the backend seam (``transport.client``,
``transport.server``), never here.

Frames are length-prefixed, versioned, and checksummed:

    offset  size  field
    0       2     magic  b"CM"
    2       1     protocol version (= 1)
    3       1     message type (``MsgType``)
    4       4     sequence number, uint32 LE (replies echo the request's)
    8       4     payload length, uint32 LE
    12      4     CRC-32 of the payload, uint32 LE
    16      len   payload

The sequence number is what keeps a connection usable after a *failed*
fan-out: a timed-out broadcast can leave a healthy worker's reply sitting
unread in the socket, and without pairing, the next request would consume
that stale frame as its own answer.  Workers echo the request's seq into
the reply, and the client discards replies whose seq is not the one it is
waiting on.

The payload is a flat field table: ``n_fields`` uint16, then per field a
length-prefixed ascii key, a one-byte tag, and a tagged value — int64
scalars, utf-8 strings, or ndarrays (dtype code, ndim, int64 dims, raw
C-order bytes).  Serialization is zero-copy on both sides of the hot path:
``encode_message`` returns the header plus the arrays' own memoryviews (no
concatenated blob is built — ``send_message`` gather-writes them), and
``decode_payload`` returns ``np.frombuffer`` views into the received buffer.

Decoding is strict: short reads raise ``TruncatedFrame``, payloads larger
than ``max_payload`` raise ``FrameTooLarge`` *before* any allocation, CRC
mismatches raise ``ChecksumError``, and unknown magic/version/tag bytes
raise ``ProtocolError``.  A clean EOF at a frame boundary is the distinct
``ConnectionClosed`` (how a peer hangup differs from a corrupt stream).

The ``QUERY`` broadcast carries the uint64 band hashes as two uint32 planes
(``split_u64``/``join_u64``) so every array lane on the hot frame is <= 32
bits — the layout device-side consumers (and the packed store itself) use —
and reassembly is an explicit, tested step instead of a dtype cast.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
import zlib

import numpy as np

MAGIC = b"CM"
VERSION = 1
# magic, version, msg type, seq, payload len, payload crc
_HEADER = struct.Struct("<2sBBIII")
HEADER_SIZE = _HEADER.size

MAX_PAYLOAD = 1 << 30                   # 1 GiB hard ceiling per frame

# Trace-context field names (``obs.trace``).  The header is frozen at
# 16 bytes, so trace ids ride as ordinary payload fields — underscore-
# prefixed to stay clear of operation fields, ignored by peers that do not
# know them (decode returns a plain dict; handlers read specific keys).
# Requests carry the trace id + parent span id; replies carry the worker's
# finished spans as a JSON string next to the echoed seq.
TRACE_ID_FIELD = "_tr"          # request: int, the 63-bit trace id
TRACE_PARENT_FIELD = "_trp"     # request: int, the coordinator's span id
TRACE_SPANS_FIELD = "_trs"      # reply: str, JSON list of worker span dicts

# Deadline field (overload control).  Same frozen-header constraint as the
# trace fields: the absolute deadline rides as an underscore-prefixed payload
# field — int64 microseconds since the unix epoch (``time.time() * 1e6``;
# workers are same-host or NTP-disciplined, and deadline checks only need
# millisecond-grade agreement).  Workers drop expired read work *before*
# computing and answer ``OVERLOADED`` with ``reason="expired"``.
DEADLINE_FIELD = "_dl"          # request: int, absolute deadline (us epoch)

# Liveness probe (``replica.supervisor``'s heartbeat): a STATS request with
# this field set is answered beside a running handler, never queued behind
# it, with ``pid`` and ``busy_us``, the microseconds the handler now running
# has held the worker's execution lock (0 when idle).
PING_FIELD = "_ping"            # request: int, 1


def deadline_us(abs_deadline_s: float) -> int:
    """Absolute deadline in seconds-since-epoch -> the wire's int64 us."""
    return int(abs_deadline_s * 1e6)


class MsgType(enum.IntEnum):
    ADD = 1          # rows=(B,K) i32 sigs  OR  words=(B,W) u32 packed
    QUERY = 2        # hash_lo/hash_hi=(Q,NB) u32, qwords=(Q,W) u32,
                     # top_k, mode ("sig"|"packed")
    BRUTE = 3        # qwords=(Q,W) u32, top_k — the global fallback leg
    PARTIAL = 4      # reply: ids=(Q,k) i64, scores=(Q,k) f32, has=(Q,) bool
    STATS = 5        # request worker counters
    OK = 6           # generic reply (ADD count, STATS counters, acks)
    SNAPSHOT = 7     # path — worker saves its SketchStore there
    SHUTDOWN = 8     # graceful worker exit (acked with OK first)
    ERROR = 9        # reply: error=str — worker-side exception text
    DIGEST = 10      # content digest of the worker's signature buffer
                     # (replica resync parity check — see replica.supervisor)
    OVERLOADED = 11  # reply: reason ("admission"|"expired"), retry_after_us,
                     # gate_depth, gate_limit — the worker did NOT execute
                     # the request (provably clean: safe to retry within
                     # budget; never poisons the plane)


class WireError(Exception):
    """Base for protocol-level failures."""


class ConnectionClosed(WireError):
    """Peer closed the stream cleanly at a frame boundary."""


class TruncatedFrame(WireError):
    """Stream ended (or buffer ran out) mid-frame."""


class ChecksumError(WireError):
    """Payload CRC-32 does not match the header."""


class FrameTooLarge(WireError):
    """Declared payload length exceeds the receiver's limit."""


class ProtocolError(WireError):
    """Bad magic, unsupported version, or malformed payload."""


# -- field encoding -----------------------------------------------------------

_TAG_INT = 0
_TAG_STR = 1
_TAG_ARR = 2

_DTYPES = (np.bool_, np.int8, np.uint8, np.int16, np.uint16, np.int32,
           np.uint32, np.int64, np.uint64, np.float32, np.float64)
_DTYPE_CODE = {np.dtype(d): i for i, d in enumerate(_DTYPES)}
_CODE_DTYPE = {i: np.dtype(d) for i, d in enumerate(_DTYPES)}


@dataclasses.dataclass
class Message:
    type: MsgType
    fields: dict
    seq: int = 0                  # request/reply pairing (uint32, echoed)

    def __getitem__(self, key):
        return self.fields[key]


def _array_view(arr: np.ndarray) -> memoryview:
    """Flat byte view of a (C-contiguified) array — the zero-copy leg of
    encoding: the frame references the array's own buffer.  Goes through a
    1-D uint8 reinterpret (not ``memoryview.cast``, which rejects 0-d and
    empty shapes)."""
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def encode_payload(fields: dict) -> list:
    """Field dict -> list of buffers (metadata chunks + raw array views)."""
    bufs: list = []
    meta = bytearray(struct.pack("<H", len(fields)))
    for key, val in fields.items():
        kb = key.encode("ascii")
        if len(kb) > 255:
            raise ProtocolError(f"field name too long: {key!r}")
        meta += struct.pack("<B", len(kb)) + kb
        if isinstance(val, (bool, int, np.integer)):
            meta += struct.pack("<Bq", _TAG_INT, int(val))
        elif isinstance(val, str):
            sb = val.encode("utf-8")
            meta += struct.pack("<BI", _TAG_STR, len(sb)) + sb
        elif isinstance(val, np.ndarray):
            if val.dtype not in _DTYPE_CODE:
                raise ProtocolError(f"unsupported array dtype {val.dtype}")
            meta += struct.pack(f"<BBB{val.ndim}q", _TAG_ARR,
                                _DTYPE_CODE[val.dtype], val.ndim, *val.shape)
            bufs.append(bytes(meta))
            meta = bytearray()
            bufs.append(_array_view(val))
        else:
            raise ProtocolError(f"unsupported field type {type(val)!r} "
                                f"for {key!r}")
    if meta:
        bufs.append(bytes(meta))
    return bufs


def encode_message(msg: Message) -> list:
    """Message -> [header, *payload buffers] ready for a gather-write."""
    payload = encode_payload(msg.fields)
    length = sum(b.nbytes if isinstance(b, memoryview) else len(b)
                 for b in payload)
    if length > MAX_PAYLOAD:
        raise FrameTooLarge(f"payload {length} exceeds MAX_PAYLOAD")
    crc = 0
    for b in payload:
        crc = zlib.crc32(b, crc)
    header = _HEADER.pack(MAGIC, VERSION, int(msg.type),
                          msg.seq & 0xFFFFFFFF, length, crc & 0xFFFFFFFF)
    return [header, *payload]


def message_bytes(msg: Message) -> bytes:
    """One contiguous frame (test/convenience path; copies)."""
    return b"".join(bytes(b) for b in encode_message(msg))


def decode_header(header: bytes, *, max_payload: int = MAX_PAYLOAD
                  ) -> tuple[MsgType, int, int, int]:
    """16-byte header -> (msg type, seq, payload length, expected crc)."""
    if len(header) < HEADER_SIZE:
        raise TruncatedFrame(f"header: got {len(header)} of {HEADER_SIZE} "
                             "bytes")
    magic, version, mtype, seq, length, crc = \
        _HEADER.unpack(header[:HEADER_SIZE])
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    if version != VERSION:
        raise ProtocolError(f"unsupported protocol version {version}")
    if length > max_payload:
        raise FrameTooLarge(f"payload {length} exceeds limit {max_payload}")
    try:
        mt = MsgType(mtype)
    except ValueError as e:
        raise ProtocolError(f"unknown message type {mtype}") from e
    return mt, seq, length, crc


def decode_payload(payload) -> dict:
    """Payload buffer -> field dict.  Arrays come back as ``np.frombuffer``
    views into ``payload`` (zero-copy, read-only)."""
    buf = memoryview(payload).cast("B")
    fields: dict = {}
    try:
        (n_fields,) = struct.unpack_from("<H", buf, 0)
        off = 2
        for _ in range(n_fields):
            (klen,) = struct.unpack_from("<B", buf, off)
            off += 1
            key = bytes(buf[off: off + klen]).decode("ascii")
            off += klen
            (tag,) = struct.unpack_from("<B", buf, off)
            off += 1
            if tag == _TAG_INT:
                (fields[key],) = struct.unpack_from("<q", buf, off)
                off += 8
            elif tag == _TAG_STR:
                (slen,) = struct.unpack_from("<I", buf, off)
                off += 4
                if off + slen > len(buf):
                    raise TruncatedFrame("string field overruns payload")
                fields[key] = bytes(buf[off: off + slen]).decode("utf-8")
                off += slen
            elif tag == _TAG_ARR:
                code, ndim = struct.unpack_from("<BB", buf, off)
                off += 2
                if code not in _CODE_DTYPE:
                    raise ProtocolError(f"unknown dtype code {code}")
                shape = struct.unpack_from(f"<{ndim}q", buf, off)
                off += 8 * ndim
                if any(d < 0 for d in shape):
                    raise ProtocolError(f"negative dim in shape {shape}")
                dt = _CODE_DTYPE[code]
                nbytes = dt.itemsize
                for d in shape:        # python ints: no int64 overflow wrap
                    nbytes *= d
                if off + nbytes > len(buf):
                    raise TruncatedFrame("array field overruns payload")
                fields[key] = np.frombuffer(
                    buf[off: off + nbytes], dtype=dt).reshape(shape)
                off += nbytes
            else:
                raise ProtocolError(f"unknown field tag {tag}")
        if off != len(buf):
            raise ProtocolError(f"{len(buf) - off} trailing payload bytes")
    except WireError:
        raise
    except struct.error as e:                  # ran off the end of the meta
        raise TruncatedFrame(str(e)) from e
    except Exception as e:
        # a CRC-valid but malformed payload (bad utf-8/ascii, absurd shape)
        # must surface as a protocol failure the server/client error paths
        # understand — never crash a worker with a raw ValueError
        raise ProtocolError(
            f"malformed payload: {type(e).__name__}: {e}") from e
    return fields


def decode_frame(frame, *, max_payload: int = MAX_PAYLOAD) -> Message:
    """One contiguous frame -> Message (header + crc + payload checks)."""
    frame = memoryview(frame).cast("B")
    mtype, seq, length, crc = decode_header(bytes(frame[:HEADER_SIZE]),
                                            max_payload=max_payload)
    payload = frame[HEADER_SIZE:]
    if len(payload) < length:
        raise TruncatedFrame(f"payload: got {len(payload)} of {length} bytes")
    if len(payload) > length:
        raise ProtocolError(f"{len(payload) - length} bytes past frame end")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise ChecksumError("payload CRC mismatch")
    return Message(mtype, decode_payload(payload), seq)


# -- socket framing -----------------------------------------------------------

def read_exact(sock, n: int) -> bytearray:
    """Read exactly n bytes; ConnectionClosed on clean EOF before byte 0,
    TruncatedFrame on EOF mid-read."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                raise ConnectionClosed("peer closed the connection")
            raise TruncatedFrame(f"stream ended at byte {len(buf)} of {n}")
        buf += chunk
    return buf


def recv_message(sock, *, max_payload: int = MAX_PAYLOAD,
                 meter=None) -> Message:
    """Blocking read of one frame from a socket.  ``meter``, if given, is
    called with the frame's total byte count (bytes-in accounting)."""
    header = read_exact(sock, HEADER_SIZE)
    mtype, seq, length, crc = decode_header(bytes(header),
                                            max_payload=max_payload)
    payload = read_exact(sock, length) if length else bytearray()
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise ChecksumError("payload CRC mismatch")
    if meter is not None:
        meter(HEADER_SIZE + length)
    return Message(mtype, decode_payload(payload), seq)


def send_message(sock, msg: Message, *, meter=None) -> None:
    """Gather-write one frame (no concatenated payload copy).  ``meter``,
    if given, is called with the frame's total byte count."""
    bufs = [memoryview(b) if not isinstance(b, memoryview) else b
            for b in encode_message(msg)]
    if meter is not None:
        meter(sum(b.nbytes for b in bufs))
    sendmsg = getattr(sock, "sendmsg", None)
    if sendmsg is None:                        # exotic socket: join + sendall
        sock.sendall(b"".join(bytes(b) for b in bufs))
        return
    while bufs:
        sent = sendmsg(bufs)
        while bufs and sent >= bufs[0].nbytes:
            sent -= bufs[0].nbytes
            bufs.pop(0)
        if bufs and sent:
            bufs[0] = bufs[0].cast("B")[sent:]


# -- uint64 band hashes as two uint32 planes ---------------------------------

def split_u64(h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(…,) uint64 -> (lo, hi) uint32 planes (the QUERY broadcast layout)."""
    h = np.asarray(h, np.uint64)
    lo = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (h >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def join_u64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Inverse of ``split_u64``."""
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | \
        np.asarray(lo, np.uint64)
