"""The port's wire protocol against the JAX package's: byte-compatible
both ways, and the same strict rejection of damaged frames.

Every case of ``tests/test_wire.py`` runs on the port's ``wire``; on top,
each frame one package encodes the other decodes to the same message, and
``message_bytes`` of the same ``Message`` is the same bytes in both
(tolerance 0: frames are bytes).  The constants a peer relies on (magic,
version, message types, dtype codes, field names, limits) and the error
taxonomy are held equal too.
"""

import socket
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.transport import wire as ref_wire
from repro_torch.transport import wire
from repro_torch.transport.wire import Message, MsgType

DTYPES = [np.bool_, np.int8, np.uint8, np.int16, np.uint16, np.int32,
          np.uint32, np.int64, np.uint64, np.float32, np.float64]


def _random_array(rng: np.random.Generator, dtype, shape):
    if dtype == np.bool_:
        return rng.integers(0, 2, shape).astype(np.bool_)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.normal(size=shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, int(info.max) + 1, shape,
                        dtype=dt, endpoint=False)


def _assert_messages_equal(a, b):
    assert int(a.type) == int(b.type)
    assert a.seq == b.seq
    assert set(a.fields) == set(b.fields)
    for key, val in a.fields.items():
        got = b.fields[key]
        if isinstance(val, np.ndarray):
            assert got.dtype == val.dtype, key
            assert got.shape == val.shape, key
            assert np.array_equal(val, got, equal_nan=True), key
        else:
            assert val == got, key


def _ref_message(msg: Message):
    return ref_wire.Message(ref_wire.MsgType(int(msg.type)),
                            dict(msg.fields), msg.seq)


def _random_message(data) -> Message:
    seed = data.draw(st.integers(0, 2**31 - 1), "seed")
    rng = np.random.default_rng(seed)
    mtype = MsgType(data.draw(st.sampled_from([int(t) for t in MsgType]),
                              "mtype"))
    fields = {}
    for fi in range(data.draw(st.integers(0, 5), "n_fields")):
        kind = data.draw(st.sampled_from(["int", "str", "arr"]), "kind")
        key = f"f{fi}_{kind}"
        if kind == "int":
            fields[key] = data.draw(st.integers(-(2**62), 2**62), "intval")
        elif kind == "str":
            n = data.draw(st.integers(0, 40), "slen")
            fields[key] = "".join(
                chr(data.draw(st.integers(32, 0x24F), "ch"))
                for _ in range(n))
        else:
            dtype = DTYPES[data.draw(st.integers(0, len(DTYPES) - 1), "dt")]
            ndim = data.draw(st.integers(0, 3), "ndim")
            shape = tuple(data.draw(st.integers(0, 5), "dim")
                          for _ in range(ndim))
            fields[key] = _random_array(rng, dtype, shape)
    return Message(mtype, fields,
                   seq=data.draw(st.integers(0, 2**32 - 1), "seq"))


# -- what a peer relies on ----------------------------------------------------

def test_constants_and_error_taxonomy_match_reference():
    assert wire.MAGIC == ref_wire.MAGIC
    assert wire.VERSION == ref_wire.VERSION
    assert wire.HEADER_SIZE == ref_wire.HEADER_SIZE == 16
    assert wire.MAX_PAYLOAD == ref_wire.MAX_PAYLOAD
    assert {t.name: int(t) for t in MsgType} == \
        {t.name: int(t) for t in ref_wire.MsgType}
    assert {str(k): v for k, v in wire._DTYPE_CODE.items()} == \
        {str(k): v for k, v in ref_wire._DTYPE_CODE.items()}
    assert (wire._TAG_INT, wire._TAG_STR, wire._TAG_ARR) == \
        (ref_wire._TAG_INT, ref_wire._TAG_STR, ref_wire._TAG_ARR)
    for name in ("TRACE_ID_FIELD", "TRACE_PARENT_FIELD", "TRACE_SPANS_FIELD",
                 "DEADLINE_FIELD"):
        assert getattr(wire, name) == getattr(ref_wire, name)
    assert wire.deadline_us(1234.5678) == ref_wire.deadline_us(1234.5678)
    for name in ("ConnectionClosed", "TruncatedFrame", "ChecksumError",
                 "FrameTooLarge", "ProtocolError"):
        assert issubclass(getattr(wire, name), wire.WireError)
        assert issubclass(getattr(ref_wire, name), ref_wire.WireError)


# -- round-trip fuzz, across the packages ------------------------------------

@settings(max_examples=60)
@given(st.data())
def test_roundtrip_fuzz(data):
    """Any field mix survives encode -> decode, through bytes and sockets,
    and each package decodes the other's frame to the same message."""
    msg = _random_message(data)
    frame = wire.message_bytes(msg)
    assert frame == ref_wire.message_bytes(_ref_message(msg))
    _assert_messages_equal(msg, wire.decode_frame(frame))
    _assert_messages_equal(msg, ref_wire.decode_frame(frame))
    a, b = socket.socketpair()
    try:
        wire.send_message(a, msg)
        _assert_messages_equal(msg, ref_wire.recv_message(b))
        ref_wire.send_message(a, _ref_message(msg))
        _assert_messages_equal(msg, wire.recv_message(b))
    finally:
        a.close()
        b.close()


def test_roundtrip_typical_query():
    """The hot-path QUERY layout, incl. the uint64 -> 2x uint32 planes."""
    rng = np.random.default_rng(0)
    hashes = rng.integers(0, 1 << 63, (7, 16)).astype(np.uint64) * \
        np.uint64(3)                       # exercise the high bit
    lo, hi = wire.split_u64(hashes)
    rlo, rhi = ref_wire.split_u64(hashes)
    assert lo.dtype == np.uint32 and hi.dtype == np.uint32
    assert np.array_equal(lo, rlo) and np.array_equal(hi, rhi)
    assert np.array_equal(wire.join_u64(lo, hi), hashes)
    assert np.array_equal(ref_wire.join_u64(lo, hi), hashes)
    msg = Message(MsgType.QUERY, {
        "hash_lo": lo, "hash_hi": hi,
        "qwords": rng.integers(0, 1 << 32, (7, 8), dtype=np.uint32),
        "top_k": 10, "mode": "packed"})
    frame = wire.message_bytes(msg)
    assert frame == ref_wire.message_bytes(_ref_message(msg))
    got = ref_wire.decode_frame(frame)
    _assert_messages_equal(msg, got)
    assert np.array_equal(
        wire.join_u64(got["hash_lo"], got["hash_hi"]), hashes)


def test_decoded_arrays_are_views():
    """Zero-copy contract: decoded arrays alias the frame buffer."""
    msg = Message(MsgType.PARTIAL,
                  {"ids": np.arange(12, dtype=np.int64).reshape(3, 4)})
    frame = wire.message_bytes(msg)
    got = wire.decode_frame(frame)
    assert got["ids"].base is not None     # a view, not a fresh allocation


# -- rejection ----------------------------------------------------------------

def _frame() -> bytes:
    return wire.message_bytes(Message(MsgType.PARTIAL, {
        "ids": np.arange(6, dtype=np.int64).reshape(2, 3),
        "scores": np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3),
        "has": np.asarray([True, False])}))


@settings(max_examples=40)
@given(st.data())
def test_truncated_frames_rejected(data):
    """Every proper prefix of a frame is rejected, never misparsed."""
    frame = _frame()
    cut = data.draw(st.integers(0, len(frame) - 1), "cut")
    with pytest.raises(wire.TruncatedFrame):
        wire.decode_frame(frame[:cut])


@settings(max_examples=40)
@given(st.data())
def test_corrupted_payload_rejected(data):
    """Any single flipped payload byte trips the checksum."""
    frame = bytearray(_frame())
    pos = data.draw(st.integers(wire.HEADER_SIZE, len(frame) - 1), "pos")
    frame[pos] ^= data.draw(st.integers(1, 255), "xor")
    with pytest.raises(wire.ChecksumError):
        wire.decode_frame(bytes(frame))


def test_oversized_frame_rejected_before_allocation():
    frame = _frame()
    with pytest.raises(wire.FrameTooLarge):
        wire.decode_frame(frame, max_payload=8)
    header = struct.pack("<2sBBIII", wire.MAGIC, wire.VERSION,
                         int(MsgType.OK), 0, wire.MAX_PAYLOAD + 1, 0)
    with pytest.raises(wire.FrameTooLarge):
        wire.decode_header(header)


def test_bad_magic_version_and_type_rejected():
    frame = bytearray(_frame())
    for pos, val in ((slice(0, 2), b"XX"), (2, 99), (3, 200)):
        bad = frame.copy()
        bad[pos] = val
        with pytest.raises(wire.ProtocolError):
            wire.decode_frame(bytes(bad))


def test_trailing_garbage_rejected():
    with pytest.raises(wire.ProtocolError):
        wire.decode_frame(_frame() + b"\x00")


def test_unsupported_field_values_rejected_at_encode():
    for val in (3.5, [1, 2], np.zeros(2, dtype=np.complex64)):
        with pytest.raises(wire.ProtocolError):
            wire.message_bytes(Message(MsgType.OK, {"x": val}))


def test_malformed_but_crc_valid_payload_rejected_as_protocol_error():
    """A CRC-valid frame with absurd content (dims overflowing int64,
    non-ascii key bytes) is a WireError, not a raw ValueError."""
    payloads = [
        struct.pack("<H", 1) + struct.pack("<B", 1) + b"x"
        + struct.pack("<BBB2q", 2, 7, 2, 1 << 33, 1 << 33),
        struct.pack("<H", 1) + struct.pack("<B", 2) + b"\xff\xfe"
        + struct.pack("<Bq", 0, 1)]
    for payload in payloads:
        frame = struct.pack("<2sBBIII", wire.MAGIC, wire.VERSION,
                            int(MsgType.OK), 0, len(payload),
                            zlib.crc32(payload))
        with pytest.raises(wire.WireError):
            wire.decode_frame(frame + payload)


def test_socket_eof_taxonomy():
    """Clean hangup at a frame boundary vs mid-frame are distinct errors."""
    a, b = socket.socketpair()
    a.close()
    with pytest.raises(wire.ConnectionClosed):
        wire.recv_message(b)
    b.close()
    a, b = socket.socketpair()
    frame = _frame()
    a.sendall(frame[: len(frame) // 2])
    a.close()                              # died mid-frame
    with pytest.raises(wire.TruncatedFrame):
        wire.recv_message(b)
    b.close()


def test_meter_counts_the_same_bytes_as_the_reference():
    """``send_message``/``recv_message`` meter whole frames: header plus
    payload, the byte counts the ``worker.bytes_*`` counters read."""
    msg = Message(MsgType.QUERY, {"qwords": np.arange(24, dtype=np.uint32)
                                  .reshape(3, 8), "top_k": 5, "mode": "sig"},
                  seq=9)
    sent, got = [], []
    a, b = socket.socketpair()
    try:
        wire.send_message(a, msg, meter=sent.append)
        ref_wire.recv_message(b, meter=got.append)
    finally:
        a.close()
        b.close()
    assert sent == got == [len(wire.message_bytes(msg))]
