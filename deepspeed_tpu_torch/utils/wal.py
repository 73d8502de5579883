"""Durable-IO primitives + CRC-framed write-ahead-log helpers.

Counterpart of ``deepspeed_tpu/utils/wal.py``, byte-compatible with it: a
log written by either package scans the same in the other.  One
implementation of the crash-safety idioms:

- atomic text writes (stage + fsync + rename), file/dir fsync, and
  whole-file CRC32 (the checkpoint manifest's idioms in the JAX package);
- ``inference/v2/journal.py``: an append-only request WAL whose frames
  carry their own length + CRC32, so a reader can replay a journal that died
  mid-append by truncating at the first bad frame instead of refusing the
  whole file.

Frame layout (little-endian): ``MAGIC(4) | payload_len u32 | crc32 u32 |
payload``.  A frame is valid iff the magic matches, the payload is fully
present, and its CRC32 matches.  The FIRST invalid frame ends the scan —
everything after a torn/corrupt frame is unreachable by construction (frame
boundaries can't be re-synchronized reliably once one length field is
garbage), which is exactly the semantics an append-only log wants: the tail
that wasn't durably written never happened.

All host-side stdlib; nothing here imports torch or numpy.
"""

import os
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

FRAME_MAGIC = b"DSWL"
_HEADER = struct.Struct("<4sII")  # magic, payload length, payload crc32
HEADER_SIZE = _HEADER.size


# --------------------------------------------------------------- durable IO
def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # fs without directory fds (or non-POSIX); rename is still atomic
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: str, text: str) -> None:
    """Stage + fsync + rename so readers never observe a partial file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")


def file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


# ------------------------------------------------------------------- frames
def encode_frame(payload: bytes) -> bytes:
    """One self-validating frame: header (magic + length + CRC32) + payload."""
    return _HEADER.pack(FRAME_MAGIC, len(payload), zlib.crc32(payload)) + payload


def append_frame(fh, payload: bytes) -> int:
    """Append one frame to an open binary file object; returns bytes written.
    The caller owns flush/fsync policy (a WAL batches those per its own
    durability knob)."""
    data = encode_frame(payload)
    fh.write(data)
    return len(data)


def iter_frames(data: bytes) -> Iterator[Tuple[bytes, int]]:
    """Yield ``(payload, end_offset)`` for each valid frame prefix of
    ``data``; stops silently at the first invalid frame (torn tail, bit
    flip, foreign bytes)."""
    off = 0
    n = len(data)
    while off + HEADER_SIZE <= n:
        magic, length, crc = _HEADER.unpack_from(data, off)
        if magic != FRAME_MAGIC:
            return
        end = off + HEADER_SIZE + length
        if end > n:
            return  # torn tail: the payload never fully landed
        payload = data[off + HEADER_SIZE:end]
        if zlib.crc32(payload) != crc:
            return  # bit flip / partial overwrite inside the payload
        yield payload, end
        off = end


def scan_frames(path: str) -> Tuple[List[bytes], int, Optional[str]]:
    """Read every valid frame of ``path``.

    Returns ``(payloads, good_size, tail_error)``: ``good_size`` is the byte
    offset just past the last valid frame, and ``tail_error`` describes the
    invalid tail (None when the file ends exactly on a frame boundary).
    A missing file reads as an empty log.
    """
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except FileNotFoundError:
        return [], 0, None
    payloads: List[bytes] = []
    good = 0
    for payload, end in iter_frames(data):
        payloads.append(payload)
        good = end
    if good == len(data):
        return payloads, good, None
    bad = len(data) - good
    if bad < HEADER_SIZE:
        detail = f"{bad} trailing byte(s) — torn header"
    else:
        magic = data[good:good + 4]
        detail = ("torn or corrupt frame" if magic == FRAME_MAGIC
                  else f"bad magic {magic!r}")
    return payloads, good, f"{detail} at offset {good} ({bad} byte(s) dropped)"


def truncate_torn_tail(path: str) -> Optional[str]:
    """Physically truncate ``path`` at the last valid frame boundary (the
    resume-from-latest-valid move applied to a log file): a writer
    reopening the journal in append mode then extends a clean prefix instead
    of burying the torn bytes under new frames — which would make every
    later record unreachable to scans.  Returns the tail description when a
    truncation happened, None when the file was already clean/missing."""
    _, good, tail_error = scan_frames(path)
    if tail_error is None:
        return None
    with open(path, "rb+") as fh:
        fh.truncate(good)
        fh.flush()
        os.fsync(fh.fileno())
    return tail_error
