"""Socket and frame helpers of the serve wire — the port's own copy of the
pieces of ``tpu_dist/collectives/transport.py`` that the JAX package's
serve frontend uses: the named checksum error, socket tuning, the vectored
send, the bounded read and the payload checksum; and, the port's own, a
close that wakes the threads blocked on a socket.

The checksum must resolve as the JAX package's does, since both ends of a
serve connection check it: CRC32C through google_crc32c's C library
(bound with ctypes, zero-copy), then google_crc32c's Python API, then the
``crc32c`` package, then zlib's CRC32 — a different polynomial.  Two
processes therefore agree only when they resolve alike, which holds on
one host with one set of packages; a host without a CRC32C package (zlib)
cannot talk to a host with one.  The tests check that this copy and the
JAX package's resolve to the same function here.
"""

from __future__ import annotations

import socket
from typing import Optional

import numpy as np

__all__ = ["FrameCorruptError", "frame_checksum"]


class FrameCorruptError(ConnectionError):
    """A frame's payload failed its checksum: the bytes that arrived are
    not the bytes that were sent.  Carries the source rank (None for a
    serve connection), the frame tag, the payload size, both CRCs and the
    stream offset.  The connection is unusable afterwards."""

    def __init__(self, peer: Optional[int], tag: str, nbytes: int,
                 expected: int, got: int, offset: int):
        self.peer = None if peer is None else int(peer)
        self.tag = tag
        self.nbytes = int(nbytes)
        self.expected = int(expected)
        self.got = int(got)
        self.offset = int(offset)
        src = "the serve peer" if peer is None else f"rank {peer}"
        super().__init__(
            f"corrupt frame from {src} tag {tag!r}: payload checksum "
            f"mismatch (expected {expected:#010x}, got {got:#010x}) over "
            f"{nbytes} bytes at stream offset {offset} — refusing to "
            f"deliver corrupt payload bytes")


def _resolve_crc_fn():  # pragma: no cover - environment-dependent
    try:
        import ctypes
        import glob
        import os

        import google_crc32c
        root = os.path.join(
            os.path.dirname(os.path.dirname(google_crc32c.__file__)),
            "google_crc32c.libs")
        lib = ctypes.CDLL(glob.glob(os.path.join(root,
                                                 "libcrc32c*.so*"))[0])
        lib.crc32c_extend.restype = ctypes.c_uint32
        lib.crc32c_extend.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                                      ctypes.c_size_t]

        def _crc_hw(data, crc=0):
            a = np.frombuffer(data, np.uint8)  # zero-copy pointer access
            return lib.crc32c_extend(crc, a.ctypes.data, a.size)

        _crc_hw(b"tpu_dist")  # prove the binding before committing to it
        return _crc_hw
    except Exception:
        pass
    try:
        from google_crc32c import extend as _gcrc

        return lambda data, crc=0: _gcrc(crc, bytes(data))
    except Exception:
        pass
    try:
        from crc32c import crc32c

        return crc32c
    except Exception:
        from zlib import crc32

        return crc32


_crc_fn = _resolve_crc_fn()


def frame_checksum(parts, seed: int = 0) -> int:
    """Streaming checksum over payload parts (in wire order)."""
    c = seed
    for p in parts:
        v = memoryview(p).cast("B").toreadonly()
        if len(v):
            c = _crc_fn(v, c)
    return c & 0xFFFFFFFF


def _tune_socket(sock) -> None:
    """TCP_NODELAY: a serve frame is small and answers wait on it."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


def _sendv(sock, header: bytes, *payloads) -> None:
    """Vectored send: header + every payload part leave in one ``sendmsg``
    syscall, no concatenation copy; partial sends resume across the
    parts."""
    parts = [memoryview(header)]
    parts.extend(memoryview(p).cast("B") for p in payloads if len(p))
    if len(parts) == 1:
        sock.sendall(header)
        return
    total = sum(len(p) for p in parts)
    done = 0
    while done < total:
        n = sock.sendmsg(parts) if len(parts) > 1 else sock.send(parts[0])
        done += n
        while parts and n >= len(parts[0]):
            n -= len(parts[0])
            parts.pop(0)
        if n and parts:
            parts[0] = parts[0][n:]


def _recv_exact(conn, n: int) -> Optional[bytearray]:
    """Read exactly ``n`` bytes into a fresh (writable) buffer.

    Returns None on EOF at a frame boundary (peer closed cleanly);
    raises ConnectionError on EOF mid-read (truncated frame)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = conn.recv_into(view[got:], n - got)
        if r == 0:
            if got == 0:
                return None
            raise ConnectionError(f"truncated frame ({got}/{n} bytes)")
        got += r
    return buf


# how long a close waits for each thread it ends (they wake at once)
_JOIN_TIMEOUT = 10.0


def _shutdown(sock) -> None:
    """Shut a socket down and close it; a thread blocked on it wakes."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass   # never connected, or the peer is already gone
    try:
        sock.close()
    except OSError:
        pass
