"""The record shard container of ``paddle_tpu/io/streaming.py``, the part
the serving prefix store reads and writes.

A shard is an 8-byte magic followed by length-framed records
``[u32 payload_len][u32 crc32(payload)][payload]``, all little-endian,
published atomically (tmp file → fsync → rename). The format is the
reference's byte for byte, so either package reads the other's shards.

Only the container is ported: ``StreamingDataset``, ``ShardManifest``
and ``rebalance_states`` (the resilient, rank-sharded reader) stay in
ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import io as _pyio
import struct
import zlib

import numpy as np

from ..utils.retry import atomic_write

__all__ = ["MAGIC", "StreamReadError", "StreamCorruptionError",
           "write_stream_shard", "read_stream_shard", "pack_arrays",
           "unpack_arrays"]

MAGIC = b"PDSTRM01"
_FRAME = struct.Struct("<II")


class StreamReadError(RuntimeError):
    """A shard open/read kept failing past the transient-retry budget. The
    shard path and byte offset identify the failing region."""

    def __init__(self, msg, path=None, offset=None):
        super().__init__(msg)
        self.path = path
        self.offset = offset


class StreamCorruptionError(RuntimeError):
    """A shard's framing or a record's CRC is wrong: the bytes on disk are
    not what the writer published. ``quarantined`` lists the positions of
    the corrupt records, where the reader knows them."""

    def __init__(self, msg, quarantined=None):
        super().__init__(msg)
        self.quarantined = list(quarantined or [])


def pack_arrays(*arrays):
    """Serialize numpy arrays into one record payload (npz, no pickle);
    the inverse is :func:`unpack_arrays`."""
    buf = _pyio.BytesIO()
    np.savez(buf, *[np.asarray(a) for a in arrays])
    return buf.getvalue()


def unpack_arrays(payload):
    """The tuple of arrays :func:`pack_arrays` wrote, in order."""
    with np.load(_pyio.BytesIO(payload), allow_pickle=False) as z:
        return tuple(z[k] for k in sorted(z.files,
                                          key=lambda n: int(n[4:])))


def write_stream_shard(path, records, encode_fn=None, fs=None):
    """Write one shard of ``records`` atomically: the destination holds the
    complete shard or does not exist. ``records`` are payloads (bytes), or
    values ``encode_fn`` turns into bytes (without it, a tuple of arrays
    goes through :func:`pack_arrays`). Returns the record count. A remote
    ``fs`` (the reference's ``fleet.utils.fs`` surface) is not ported:
    any ``fs`` raises."""
    if fs is not None:
        raise NotImplementedError(
            "write_stream_shard(fs=...) needs the fleet.utils.fs surface, "
            "not ported yet (ROADMAP Queue 1, item 10)")
    n = 0

    def body(f):
        nonlocal n
        n = 0
        f.write(MAGIC)
        for rec in records:
            if not isinstance(rec, (bytes, bytearray)):
                rec = (encode_fn(rec) if encode_fn is not None
                       else pack_arrays(*rec) if isinstance(rec, tuple)
                       else pack_arrays(rec))
            f.write(_FRAME.pack(len(rec), zlib.crc32(rec)))
            f.write(rec)
            n += 1

    atomic_write(path, body)
    return n


def read_stream_shard(path, decode_fn=None):
    """Every decoded record of one shard (``decode_fn`` defaults to
    :func:`unpack_arrays`), raising :class:`StreamCorruptionError` on a bad
    magic, a torn frame or a CRC mismatch."""
    decode_fn = decode_fn or unpack_arrays
    out = []
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise StreamCorruptionError(f"{path}: bad shard magic")
        while True:
            hdr = f.read(_FRAME.size)
            if not hdr:
                return out
            if len(hdr) < _FRAME.size:
                raise StreamCorruptionError(f"{path}: torn frame header")
            length, crc = _FRAME.unpack(hdr)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                raise StreamCorruptionError(f"{path}: corrupt record")
            out.append(decode_fn(payload))
