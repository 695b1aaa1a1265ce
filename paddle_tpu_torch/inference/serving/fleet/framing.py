"""CRC-framed KV-page transfer format (counterpart of
``paddle_tpu/inference/serving/fleet/framing.py``, the same wire format
byte for byte): the one implementation shared by the prefill replica
(emit), the router (verify and forward) and the decode replica (verify
and join). Raw page bytes are split into ``FRAME_BYTES`` chunks, each
carried base64-encoded beside the ``zlib.crc32`` of the raw chunk, with a
whole-payload CRC checked after the join, so a change to the frame shape
cannot silently desynchronize an emitter from a verifier. Either
package's frames decode in the other.
"""

from __future__ import annotations

import base64
import os
import zlib

__all__ = ["FRAME_BYTES", "split_frames", "encode_frame", "decode_frame",
           "join_frames"]

# Raw payload bytes per frame. Small enough that a mid-transfer kill
# genuinely interrupts a handoff, large enough that base64+JSON
# overhead stays negligible; drills shrink it via env to force
# multi-frame transfers on tiny models (PADDLE_KV_FRAME_BYTES).
FRAME_BYTES = int(os.environ.get("PADDLE_KV_FRAME_BYTES", "65536") or
                  65536)


def split_frames(blob, frame_bytes=None):
    """``blob`` as a list of raw chunks of at most ``frame_bytes``."""
    n = int(frame_bytes or FRAME_BYTES)
    return [blob[i:i + n] for i in range(0, len(blob), n)]


def encode_frame(chunk, corrupt=False):
    """``{"crc", "data"}`` fields for one raw chunk. ``corrupt=True``
    (the ``serve.kv_transfer_corrupt`` fault site) flips bits AFTER the
    CRC was computed, so the receiver's check must catch exactly this."""
    data = chunk
    if corrupt and data:
        data = bytes([data[0] ^ 0xFF]) + data[1:]
    return {"crc": zlib.crc32(chunk),
            "data": base64.b64encode(data).decode()}


def decode_frame(ev):
    """The raw chunk bytes of one frame event/command, or ``None`` when
    the payload is undecodable or fails its CRC — the caller treats
    either as a corrupt transfer."""
    try:
        chunk = base64.b64decode(ev.get("data") or "")
    except (ValueError, TypeError):
        return None
    if zlib.crc32(chunk) != ev.get("crc"):
        return None
    return chunk


def join_frames(frames, total, crc):
    """Reassemble ``{seq: chunk}`` into ``(blob, None)``, or
    ``(None, why)`` when frames are missing or the whole-payload CRC
    disagrees."""
    total = int(total)
    got = sum(1 for i in range(total) if i in frames)
    if got != total:
        return None, f"only {got}/{total} frames arrived"
    blob = b"".join(frames[i] for i in range(total))
    if total and zlib.crc32(blob) != crc:
        return None, "payload CRC mismatch"
    return blob, None
