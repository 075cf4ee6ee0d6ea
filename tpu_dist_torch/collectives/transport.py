"""Peer-to-peer data plane for host collectives — the port's copy of
``tpu_dist/collectives/transport.py``, on its wire format.

Each rank opens a listening socket and publishes ``host:port`` in the
control-plane store under :func:`dp_addr_key`; a sender dials a peer's
listener on first use and keeps the connection (one per direction), opening
it with a hello frame that carries its rank and generation — a hello from
another generation is refused, so a rank of a failed incarnation cannot
inject frames.  One reader thread per inbound connection drains frames into
per-``(src, tag)`` FIFO queues, so a ring step where every rank sends
before it receives cannot deadlock on full TCP buffers.

A frame is ``u32 len + tag | u16 len + dtype name | u8 ndim + u64 dims |
u64 payload bytes``, then the payload.  ``!`` before the dtype name means a
4-byte payload checksum follows the header (``TPU_DIST_FRAME_CRC``, on by
default; CRC32C where ``google_crc32c`` or ``crc32c`` is importable, zlib's
CRC32 otherwise, resolved as the JAX package resolves it); ``&`` means the
payload is in the pair's shared-memory lane (:mod:`.shm`).  Quantized
frames are named ``q8b{block}`` and carry the float32 scales, then the
int8 payload.  Low-precision floats travel as their 2- or 1-byte patterns
under the JAX names (``bfloat16``, ``float8_*``; :mod:`._lowp`), so a JAX
rank and a port rank exchange every frame.

Failures are named: :class:`PeerGoneError` (EOF or reset on a peer's
connection, naming the rank), :class:`FrameCorruptError` (a checksum
mismatch, with the tag, offset and both CRCs) and
:class:`CollectiveTimeoutError` (the ring's watchdog,
``TPU_DIST_COLL_TIMEOUT``).

Env knobs: ``TPU_DIST_DP_HOST`` (advertised address), ``TPU_DIST_SHM`` /
``TPU_DIST_SHM_RING`` / ``TPU_DIST_SHM_CHUNK`` (lanes), ``TPU_DIST_DP_TIMEOUT``
(per-frame recv deadline, 300 s), ``TPU_DIST_COLL_TIMEOUT`` (the
collective watchdog, 0 = off), ``TPU_DIST_FRAME_CRC``,
``TPU_DIST_DIAL_TIMEOUT`` (60 s), ``TPU_DIST_SOCK_BUF`` (socket buffer
bytes, 0 = the OS default) and ``TPU_DIST_NO_DATAPLANE=1`` (off).  Lifecycle events (peer connect,
peer gone, SHM lanes) go to the flight recorder (:mod:`tpu_dist_torch.obs`)
when it is armed.  ``TPU_DIST_NETCHAOS`` (deterministic network fault
injection, :mod:`tpu_dist_torch.resilience.netchaos`) acts at the frame
boundary (``tcp``) and on the SHM lanes (``shm``); a collective on a
group's NCCL backend never reaches this module, so it has no surface.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

from . import _lowp

__all__ = ["DataPlane", "PeerGoneError", "FrameCorruptError",
           "CollectiveTimeoutError", "get_data_plane", "close_data_plane",
           "frame_crc_enabled", "frame_checksum", "crc_impl", "coll_timeout",
           "dp_addr_key", "store_routed_host"]


def dp_addr_key(generation: int, rank: int) -> str:
    """The store key under which ``rank`` publishes its data-plane
    listener address — THE definition of the key contract; anything that
    probes for a published address (e.g. roles channels deciding
    store-vs-dataplane routing) must build the key here."""
    return f"tpu_dist/g{generation}/dp/addr/{rank}"

_MAGIC = b"TPDP"
_HELLO = struct.Struct("<4sII")      # magic, rank, generation
# in-band SHM control frame (lane announce) + the dtype-name marker that
# says "payload bytes are in the announced lane, not on this socket".
# User tags are store-key-shaped paths, so the NUL prefix cannot collide.
_SHM_TAG = "\x00shm-lane"
_SHM_MARK = "&"
# dtype-name marker: a 4-byte payload checksum follows the frame header
# (composable with the SHM mark, which stays outermost: "&!float32")
_CRC_MARK = "!"
_CONTROL = object()   # _read_frame sentinel: handled frame, nothing to queue
_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_CONNECT_TIMEOUT = 60.0


def _connect_deadline() -> float:
    """Overall budget for dialing a peer's listener
    (``TPU_DIST_DIAL_TIMEOUT``, default 60 s) — individual dials retry
    under exponential backoff inside it, so a peer mid-restart is a
    transparent retry and a dead one a bounded named error."""
    try:
        return max(0.1, float(os.environ.get("TPU_DIST_DIAL_TIMEOUT",
                                             str(_CONNECT_TIMEOUT))))
    except ValueError:
        return _CONNECT_TIMEOUT


class PeerGoneError(ConnectionError):
    """A data-plane peer died (EOF/reset on its connection, or a send to it
    failed).  Carries the peer's rank so supervisors and tests can name the
    lost rank instead of pattern-matching an errno."""

    def __init__(self, peer: int, detail: str = ""):
        self.peer = int(peer)
        self.detail = detail
        msg = f"data-plane peer rank {peer} is gone"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class FrameCorruptError(ConnectionError):
    """A frame's payload failed its checksum: the bytes that arrived are
    not the bytes that were sent.  Carries the source rank, the frame tag,
    the stream offset (payload bytes previously delivered on this
    connection) and both CRCs — the named alternative to silently folding
    a flipped bit into gradients.  The connection is unusable afterwards
    (stream integrity is lost), so the peer is marked gone and every
    blocked recv re-raises this error."""

    def __init__(self, peer: Optional[int], tag: str, nbytes: int,
                 expected: int, got: int, offset: int):
        self.peer = None if peer is None else int(peer)
        self.tag = tag
        self.nbytes = int(nbytes)
        self.expected = int(expected)
        self.got = int(got)
        self.offset = int(offset)
        src = ("the control-plane store" if peer is None
               else f"rank {peer}")
        super().__init__(
            f"corrupt frame from {src} tag {tag!r}: payload checksum "
            f"mismatch (expected {expected:#010x}, got {got:#010x}) over "
            f"{nbytes} bytes at stream offset {offset} — refusing to "
            f"deliver corrupt payload bytes")


class CollectiveTimeoutError(TimeoutError):
    """A host collective failed to complete within
    ``TPU_DIST_COLL_TIMEOUT``: some hop of the ring/tree never delivered
    (a network partition, a wedged peer).  The message names the stalled
    hop (which peer, which span, which tag) and, when the flight recorder
    is armed, this rank's last recorded position — the diagnosis a silent
    hang never yields."""


def coll_timeout() -> float:
    """End-to-end collective watchdog budget in seconds
    (``TPU_DIST_COLL_TIMEOUT``; 0/unset = disabled — each blocking recv
    then falls back to the per-frame ``TPU_DIST_DP_TIMEOUT``)."""
    try:
        return max(0.0, float(os.environ.get("TPU_DIST_COLL_TIMEOUT",
                                             "0") or 0))
    except ValueError:
        return 0.0


# CRC32C when a native implementation is reachable — hardware (SSE4.2)
# CRC32C runs ~20 GB/s, which is what keeps the armed-overhead gate < 5%
# even on loopback where the "wire" moves at memory speed.  Resolution
# order: (1) the raw C ``crc32c_extend`` from the library google_crc32c
# ships, bound zero-copy through ctypes (the package's own Python entry
# point only accepts ``bytes``, which would force a copy per frame);
# (2) google_crc32c's Python API (bytes copy, still ~5 GB/s); (3) the
# ``crc32c`` package; (4) zlib's CRC32 (~1 GB/s, different polynomial,
# same 4-byte integrity contract).  The marker byte travels per frame, so
# hosts resolving different implementations MUST NOT be mixed in one gang
# — like every wire knob, TPU_DIST_FRAME_CRC is launcher-uniform and the
# resolution is environment-deterministic.


def _resolve_crc_fn():  # pragma: no cover - environment-dependent
    try:
        import ctypes
        import glob

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


def crc_impl() -> str:
    """Which checksum :func:`frame_checksum` resolved to (every rank of a
    gang must resolve the same one)."""
    name = getattr(_crc_fn, "__name__", "")
    if name == "_crc_hw":
        return "crc32c (google_crc32c, native)"
    if name == "<lambda>":
        return "crc32c (google_crc32c)"
    module = getattr(_crc_fn, "__module__", None) or ""
    return "zlib.crc32" if module == "zlib" else f"crc32c ({module})"


def frame_checksum(parts, seed: int = 0) -> int:
    """Streaming checksum over payload parts (in wire order)."""
    c = seed
    for p in parts:
        v = memoryview(p).cast("B").toreadonly()
        if len(v):
            c = _crc_fn(v, c)
    return c & 0xFFFFFFFF


def frame_crc_enabled() -> bool:
    """Whether outgoing frames carry payload checksums
    (``TPU_DIST_FRAME_CRC``; armed by default).  Read per send, and
    one-sided-safe: the receiver verifies exactly the frames that arrive
    marked."""
    return os.environ.get("TPU_DIST_FRAME_CRC", "auto").strip().lower() \
        not in ("0", "off", "false", "no")


def _net_chaos():
    """The active network-fault injector, or None.  Guarded by
    ``sys.modules`` and the env var, so a process that never arms the
    network chaos layer never imports it: the disarmed per-frame cost is
    two dict lookups."""
    import sys
    if "tpu_dist_torch.resilience.netchaos" not in sys.modules \
            and not os.environ.get("TPU_DIST_NETCHAOS"):
        return None
    from ..resilience import netchaos
    return netchaos.install_from_env()


def _default_timeout() -> float:
    try:
        return float(os.environ.get("TPU_DIST_DP_TIMEOUT", "300"))
    except ValueError:
        return 300.0


def _sock_buf_bytes() -> int:
    """Requested ``SO_SNDBUF``/``SO_RCVBUF`` size (``TPU_DIST_SOCK_BUF``;
    0 = keep the OS default).  Bigger buffers keep a whole ring sub-chunk
    in flight per direction on high-BDP links."""
    try:
        return max(0, int(os.environ.get("TPU_DIST_SOCK_BUF", "0")))
    except ValueError:
        return 0


def _tune_socket(sock) -> Tuple[int, int]:
    """Apply TCP_NODELAY + requested buffer sizes; returns the negotiated
    ``(sndbuf, rcvbuf)`` the kernel actually granted (it may clamp or, on
    Linux, double the request)."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    want = _sock_buf_bytes()
    if want:
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, want)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, want)
        except OSError:
            pass  # a clamped/refused request is diagnostic, not fatal
    try:
        return (sock.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF),
                sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF))
    except OSError:
        return (0, 0)


def store_routed_host(store) -> str:
    """The local interface that routes toward the control-plane store —
    the address peers on OTHER hosts can reach this process on (a UDP
    ``connect`` resolves the route without sending traffic).  Loopback
    when the store is local/absent.  Shared by the data plane's address
    advertisement and the serve gateway's discovery key — one probe, so
    the two can never publish inconsistent interfaces."""
    target = getattr(store, "host", None)
    if not target or target in ("127.0.0.1", "localhost", "0.0.0.0", ""):
        return "127.0.0.1"
    try:
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.connect((target, int(getattr(store, "port", 1))))
            return probe.getsockname()[0]
        finally:
            probe.close()
    except OSError:
        return "127.0.0.1"


def _sendv(sock, header: bytes, *payloads) -> None:
    """Vectored send: header + every payload part leave in one ``sendmsg``
    syscall — no concat copy of the payloads, no separate header segment
    on the wire.  Quantized frames pass two parts (scales, int8 payload);
    plain frames one.  Falls back to sequential ``sendall`` where
    ``sendmsg`` is missing."""
    parts = [memoryview(header)]
    parts.extend(memoryview(p).cast("B") for p in payloads if len(p))
    if len(parts) == 1:
        sock.sendall(header)
        return
    if not hasattr(sock, "sendmsg"):
        for p in parts:
            sock.sendall(p)
        return
    total = sum(len(p) for p in parts)
    done = 0
    while done < total:  # partial vectored sends resume across the parts
        n = sock.sendmsg(parts) if len(parts) > 1 else sock.send(parts[0])
        done += n
        while parts and n >= len(parts[0]):
            n -= len(parts[0])
            parts.pop(0)
        if n and parts:
            parts[0] = parts[0][n:]


def _sendv_paced(sock, header: bytes, parts, rate: float) -> None:
    """Throttled send (netchaos ``slow-drip``): the header goes out whole
    (the receiver's framing must progress), the payload drips at ``rate``
    bytes/s in ~10 ms slices.  A degradation, not an error: the frame
    completes, slowly, bounded by the caller's deadlines."""
    sock.sendall(header)
    rate = max(1.0, float(rate))
    chunk = max(1, int(rate * 0.01))
    for p in parts:
        view = memoryview(p).cast("B")
        for off in range(0, len(view), chunk):
            piece = view[off:off + chunk]
            sock.sendall(piece)
            time.sleep(len(piece) / rate)


def _inject_break(sock, header: bytes, parts, plan) -> None:
    """netchaos ``conn-reset`` / ``truncate``: break the connection
    mid-frame and raise — the sender's error path names it a
    ``PeerGoneError``; the receiver's framing sees a reset or a truncated
    frame and marks the peer gone the same way."""
    if plan.kind == "truncate":
        # the header promises the whole payload; deliver half of the first
        # part, then FIN: the receiver raises at that byte
        sock.sendall(header)
        first = memoryview(parts[0]).cast("B") if parts else b""
        if len(first):
            sock.sendall(first[:max(1, len(first) // 2)])
        try:
            sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
    else:
        # RST mid-header: closing with SO_LINGER(0) drops the send queue
        # and resets (ECONNRESET at the peer)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
        except OSError:
            pass
        sock.sendall(header[:max(1, len(header) // 2)])
    sock.close()
    raise ConnectionResetError(f"netchaos: injected {plan.kind} mid-frame")


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


def _decode_dtype(name: str) -> np.dtype:
    # bfloat16 and float8_* decode to their bit patterns (_lowp)
    return _lowp.decode_dtype(name)


def _encode_frame_header(tag: bytes, dtype_name: bytes, shape,
                         payload_len: int) -> bytes:
    parts = [_U32.pack(len(tag)), tag,
             _U16.pack(len(dtype_name)), dtype_name,
             _U8.pack(len(shape))]
    parts.extend(_U64.pack(int(d)) for d in shape)
    parts.append(_U64.pack(payload_len))
    return b"".join(parts)


class DataPlane:
    """Per-process endpoint of the rank↔rank data plane.

    Opens a listening socket at construction and publishes its address to
    the control-plane store under
    ``tpu_dist/g{generation}/dp/addr/{rank}``; peers resolve each other
    through those keys on first send.  All methods are thread-safe.
    """

    def __init__(self, store, rank: int, num_processes: int,
                 generation: int = 0):
        self.rank = int(rank)
        self.num_processes = int(num_processes)
        self.generation = int(generation)
        self._store = store
        self._closing = False

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", 0))
        self._listener.listen(max(8, num_processes * 2))
        self.port = self._listener.getsockname()[1]

        # inbound frame queues + liveness, all under one condition variable
        self._cv = threading.Condition()
        self._in_q: Dict[Tuple[int, str], deque] = {}
        self._dead: Dict[int, str] = {}
        # peer -> the exception that killed its connection, when it is a
        # NAMED diagnosis (FrameCorruptError): blocked recvs re-raise the
        # named class instead of a generic PeerGoneError
        self._dead_errs: Dict[int, BaseException] = {}
        self._in_conn: Dict[int, object] = {}  # peer -> current inbound sock
        self._rx_off: Dict[int, int] = {}      # id(conn) -> payload bytes in

        # outbound connections, one per destination, each with its own lock
        # so concurrent senders to different peers do not serialize
        self._out: Dict[int, socket.socket] = {}
        self._out_locks: Dict[int, threading.Lock] = {}
        self._out_mu = threading.Lock()

        # shared-memory payload lanes (tpu_dist/collectives/shm.py):
        # outbound per co-located destination (we create + own), inbound
        # per announcing CONNECTION (keyed id(conn) — a reconnecting
        # sender announces a fresh lane while the old connection's reader
        # may still be draining the old one).  _shm_tried remembers a
        # definitively failed/declined setup so sends stop re-probing.
        self._shm_out: Dict[int, object] = {}
        self._shm_in: Dict[int, object] = {}
        self._shm_tried: Dict[int, bool] = {}
        self._peer_host: Dict[int, bool] = {}  # dst -> co-located?

        from .topology import host_fingerprint, publish_host_fingerprint
        self.host_id = host_fingerprint(self.rank)
        # host key BEFORE the addr key: peers wait on addr, so by the time
        # an address is visible the fingerprint is too (no second wait)
        publish_host_fingerprint(store, self.rank, self.generation)
        self.addr = f"{self._advertised_host()}:{self.port}"
        store.set(self._addr_key(self.rank), self.addr.encode())

        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"tpu_dist-dp-accept-r{rank}")
        self._accept_thread.start()
        # interpreter-exit close (idempotent; close() unregisters it so a
        # superseded incarnation's DataPlane is not pinned for process
        # lifetime): drops lane mappings and sockets even when the process
        # never reaches rendezvous.shutdown.  The exit-time variant must
        # NOT touch the store: a client round-trip (native libtpudist)
        # during interpreter teardown segfaults, and the addr key is
        # generation-scoped debris the reaper covers.
        import atexit
        atexit.register(self.close, _at_exit=True)

    # -- addressing ----------------------------------------------------------

    def _addr_key(self, rank: int) -> str:
        return dp_addr_key(self.generation, rank)

    def _host_key(self, rank: int) -> str:
        from .topology import host_key
        return host_key(self.generation, rank)

    def _advertised_host(self) -> str:
        host = os.environ.get("TPU_DIST_DP_HOST")
        if host:
            return host
        return store_routed_host(self._store)

    # -- inbound -------------------------------------------------------------

    def _accept_loop(self):
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            bufs = _tune_socket(conn)
            threading.Thread(target=self._reader, args=(conn, bufs),
                             daemon=True,
                             name=f"tpu_dist-dp-reader-r{self.rank}").start()

    def _reader(self, conn, bufs=(0, 0)):
        peer = None
        detail = "connection closed"
        named_err = None
        try:
            hello = _recv_exact(conn, _HELLO.size)
            if hello is None:
                return
            magic, peer, gen = _HELLO.unpack(bytes(hello))
            if magic != _MAGIC:
                peer = None
                return
            if gen != self.generation:
                # straggler from a failed incarnation: refuse its frames,
                # but do NOT mark the rank dead in THIS generation
                peer = None
                return
            with self._cv:
                # a valid hello supersedes any earlier death mark: the peer
                # reconnected after a transient drop, so future recvs must
                # wait for its frames again instead of failing spuriously
                self._dead.pop(peer, None)
                self._dead_errs.pop(peer, None)
                self._in_conn[peer] = conn
            self._obs("peer-connect", peer, sndbuf=bufs[0], rcvbuf=bufs[1])
            while True:
                frame = self._read_frame(conn, peer)
                if frame is None:
                    break
                if frame is _CONTROL:
                    continue  # lane announce — handled inside _read_frame
                tag, arr = frame
                with self._cv:
                    self._in_q.setdefault((peer, tag), deque()).append(arr)
                    self._cv.notify_all()
        except OSError as e:
            detail = repr(e)
            if isinstance(e, FrameCorruptError):
                # keep the NAMED diagnosis: blocked recvs re-raise exactly
                # this (src/tag/offset) instead of a generic peer-gone
                named_err = e
        finally:
            try:
                conn.close()
            except OSError:
                pass
            self._rx_off.pop(id(conn), None)
            lane = self._shm_in.pop(id(conn), None)
            if lane is not None:
                lane.close()  # this reader owned the mapping
            if peer is not None and not self._closing:
                died = False
                with self._cv:
                    # only this peer's CURRENT connection may declare it
                    # dead: a stale reader observing its own superseded
                    # socket's reset must not flag a reconnected live peer
                    if self._in_conn.get(peer) is conn:
                        del self._in_conn[peer]
                        self._dead[peer] = detail
                        if named_err is not None:
                            self._dead_errs[peer] = named_err
                        self._cv.notify_all()
                        died = True
                if died:
                    # a dead peer will never attach our announced lane:
                    # reap the name now (no-op if it already attached) so
                    # a crashed pair leaves no /dev/shm debris.  The lane
                    # object stays; a failed send replaces it.
                    lane = self._shm_out.get(peer)
                    if lane is not None:
                        lane.unlink()
                    self._obs("peer-gone", peer, detail=detail,
                              outcome=("error:FrameCorrupt"
                                       if named_err is not None
                                       else "error:PeerGone"))

    def _read_frame(self, conn, peer):
        raw = _recv_exact(conn, _U32.size)
        if raw is None:
            return None
        (tlen,) = _U32.unpack(bytes(raw))
        tag = bytes(_recv_exact_or_raise(conn, tlen)).decode()
        (dlen,) = _U16.unpack(bytes(_recv_exact_or_raise(conn, _U16.size)))
        dtype_name = bytes(_recv_exact_or_raise(conn, dlen)).decode()
        (ndim,) = _U8.unpack(bytes(_recv_exact_or_raise(conn, _U8.size)))
        shape = tuple(
            _U64.unpack(bytes(_recv_exact_or_raise(conn, _U64.size)))[0]
            for _ in range(ndim))
        (plen,) = _U64.unpack(bytes(_recv_exact_or_raise(conn, _U64.size)))
        lane_mode = dtype_name.startswith(_SHM_MARK)
        if lane_mode:
            dtype_name = dtype_name[len(_SHM_MARK):]
        crc_expected = None
        if dtype_name.startswith(_CRC_MARK):
            # a payload checksum follows the header (always on the TCP
            # socket — in lane mode the payload bytes are in shared
            # memory, but the integrity word rides the ordered stream)
            dtype_name = dtype_name[len(_CRC_MARK):]
            (crc_expected,) = _U32.unpack(
                bytes(_recv_exact_or_raise(conn, _U32.size)))
        if lane_mode:
            # payload bytes live in the announced SHM lane, not on the
            # socket — drain them there (same framing contract otherwise)
            payload = self._lane_read(conn, peer, plen)
        else:
            payload = (_recv_exact_or_raise(conn, plen) if plen
                       else bytearray())
        if crc_expected is not None:
            got = frame_checksum((payload,))
            if got != crc_expected:
                raise FrameCorruptError(
                    peer if peer is not None else -1, tag, plen,
                    crc_expected, got, self._rx_off.get(id(conn), 0))
        self._rx_off[id(conn)] = self._rx_off.get(id(conn), 0) + plen
        if tag == _SHM_TAG:
            self._attach_lane(conn, peer, payload)
            return _CONTROL
        if dtype_name.startswith("q8b"):
            return tag, _decode_quant(dtype_name, shape, payload, plen)
        dtype = _decode_dtype(dtype_name)
        # zero-copy: the ndarray wraps the receive buffer (writable, owned
        # by the frame) — no pickle, no second materialization
        arr = np.frombuffer(payload, dtype=dtype)
        if arr.size != int(np.prod(shape, dtype=np.int64)):
            raise ConnectionError(
                f"frame payload {plen}B does not match shape {shape} "
                f"dtype {dtype}")
        return tag, arr.reshape(shape)

    # -- shared-memory lanes (tpu_dist/collectives/shm.py) -------------------

    @staticmethod
    def _peek_dead(sock) -> Optional[str]:
        """Non-blocking liveness probe of a peer socket while parked in a
        lane wait: EOF/reset means the peer died mid-frame (pending data —
        e.g. the next frame header — means it is alive and streaming)."""
        try:
            b = sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT)
            if b == b"":
                return "peer closed the connection mid-shm-frame"
        except (BlockingIOError, InterruptedError):
            return None
        except OSError as e:
            return f"connection error mid-shm-frame: {e!r}"
        return None

    def _lane_abort(self, sock):
        def check() -> Optional[str]:
            if self._closing:
                return "data plane closed"
            return self._peek_dead(sock)
        return check

    def _lane_read(self, conn, peer, plen: int) -> bytearray:
        # lanes are keyed by CONNECTION, not peer: after a sender
        # reconnect, the old connection's reader may still be draining
        # frames that reference the old lane while the new connection has
        # already announced a fresh one — each reader must keep consuming
        # exactly the lane its own stream announced
        lane = self._shm_in.get(id(conn))
        if lane is None:
            raise ConnectionError(
                f"rank {peer} sent an shm-lane frame but never announced "
                f"a lane on this connection")
        buf = bytearray(plen)
        if plen:
            lane.read_into(buf, timeout=_default_timeout(),
                           abort_check=self._lane_abort(conn))
        return buf

    def _attach_lane(self, conn, peer, payload) -> None:
        info = json.loads(bytes(payload).decode())
        from .shm import ShmLane
        old = self._shm_in.pop(id(conn), None)
        if old is not None:
            old.close()  # re-announce on the SAME connection (shouldn't
            # happen, but must not leak the mapping)
        try:
            self._shm_in[id(conn)] = ShmLane(name=info["name"],
                                             capacity=info.get("capacity",
                                                               0))
        except Exception as e:
            # the sender will stream payloads we cannot reach — this
            # connection is unusable; fail it loudly (fingerprints lying
            # about co-location is the only way here)
            raise ConnectionError(
                f"failed to attach shm lane {info.get('name')!r} announced "
                f"by rank {peer} (host fingerprints claim co-location but "
                f"the segment is unreachable): {e!r}") from e
        self._obs("shm-lane", peer, name=info["name"], role="attached")

    def _maybe_lane(self, dst: int, sock):
        """The outbound SHM lane to ``dst``, set up on first use when the
        peer is co-located and SHM is enabled; None otherwise (inline TCP
        payloads).  Called under the destination's send lock.  Setup
        failure falls back to TCP silently — only this rank's sends are
        affected, so one-sided degradation cannot wedge a ring."""
        from . import shm as _shm
        if not _shm.shm_enabled():
            return None
        lane = self._shm_out.get(dst)
        if lane is not None:
            return lane
        if self._shm_tried.get(dst):
            return None
        if not self.colocated(dst):
            # stop probing only on a DEFINITIVE different-host answer; an
            # unpublished fingerprint / transient store error stays
            # uncached so a later send re-resolves (colocated()'s contract)
            if dst in self._peer_host:
                self._shm_tried[dst] = True
            return None
        try:
            lane = _shm.ShmLane(create=True, generation=self.generation)
        except Exception:
            self._shm_tried[dst] = True  # no /dev/shm etc. — TCP fallback
            return None
        info = json.dumps({"name": lane.name,
                           "capacity": lane.capacity}).encode()
        header = _encode_frame_header(_SHM_TAG.encode(), b"uint8",
                                      (len(info),), len(info))
        try:
            _sendv(sock, header, info)
        except OSError:
            lane.unlink()  # the announce never left: nobody will attach
            lane.close()
            raise  # connection trouble: the caller's send error path owns it
        self._shm_out[dst] = lane
        self._obs("shm-lane", dst, name=lane.name, role="owner",
                  capacity=lane.capacity)
        return lane

    def shm_active(self, dst: int) -> bool:
        """True when an outbound shared-memory lane to ``dst`` is up
        (introspection for tests/benchmarks)."""
        return dst in self._shm_out

    def colocated(self, dst: int) -> bool:
        """Whether ``dst`` shares this rank's host fingerprint (cached;
        False until the peer has published — callers treat that as 'not
        yet known', and the send path re-resolves at lane setup)."""
        got = self._peer_host.get(dst)
        if got is None:
            from .topology import parse_host_record
            try:
                key = self._host_key(dst)
                if not self._store.check(key):
                    return False  # unpublished: do NOT cache the miss
                peer_host, _ = parse_host_record(self._store.get(key))
                got = peer_host == self.host_id
            except Exception:
                return False
            self._peer_host[dst] = got
        return got

    def send_chunk_bytes(self, dst: int, base: int) -> int:
        """Per-destination wire-frame grain for the ring
        (tpu_dist/collectives/ring.py): shared-memory destinations take
        far coarser frames (``TPU_DIST_SHM_CHUNK``, default 4 MiB) — the
        transfer is a memcpy, so fine-grained pipelining only multiplies
        per-frame overhead; TCP destinations keep ``base``."""
        from . import shm as _shm
        if not _shm.shm_enabled() or not self.colocated(dst):
            return base
        try:
            return max(base, int(os.environ.get("TPU_DIST_SHM_CHUNK",
                                                str(4 << 20))))
        except ValueError:
            return max(base, 4 << 20)

    # -- outbound ------------------------------------------------------------

    def _out_lock(self, dst: int) -> threading.Lock:
        with self._out_mu:
            lock = self._out_locks.get(dst)
            if lock is None:
                lock = self._out_locks[dst] = threading.Lock()
            return lock

    def _connect(self, dst: int) -> socket.socket:
        # bounded wait for the peer's address: a blocking store.get here
        # would hang forever (holding this destination's send lock) when
        # the peer died before constructing its DataPlane
        key = self._addr_key(dst)
        timeout = _default_timeout()
        try:
            self._store.wait([key], timeout=timeout if timeout > 0 else None)
        except TimeoutError as e:
            raise PeerGoneError(
                dst, f"never published a data-plane address: {e}") from e
        raw = self._store.get(key)
        host, _, port = raw.decode().rpartition(":")

        def _dial():
            sock = socket.create_connection((host, int(port)), timeout=5.0)
            try:
                _tune_socket(sock)
                sock.settimeout(None)
                sock.sendall(_HELLO.pack(_MAGIC, self.rank,
                                         self.generation))
            except OSError:
                sock.close()
                raise
            return sock

        # bounded exponential backoff instead of a one-shot dial: a peer
        # mid-restart (listener briefly down, address re-published an
        # instant later) retries transparently; a peer that stays
        # unreachable is a named error within _connect_deadline() seconds
        from ..utils.backoff import BackoffDeadlineError, retry_call
        try:
            return retry_call(_dial, timeout=_connect_deadline(),
                              what=f"dial data-plane peer rank {dst}")
        except BackoffDeadlineError as e:
            raise PeerGoneError(
                dst, f"listener at {host}:{port} unreachable after "
                f"{e.timeout:.0f}s of bounded-backoff dials "
                f"(TPU_DIST_DIAL_TIMEOUT): {e.last!r}") from e

    def send_array(self, dst: int, tag: str, arr) -> int:
        """Send one array frame to ``dst``; returns payload bytes sent.

        Blocking, but never deadlocks against a peer doing the same: the
        peer's reader thread is always draining its socket.  Raises
        :class:`PeerGoneError` if the connection to ``dst`` fails."""
        arr = np.asarray(arr)
        shape = arr.shape  # before ascontiguousarray, which flattens 0-d
        arr = np.ascontiguousarray(arr)
        payload = memoryview(arr.reshape(-1).view(np.uint8))
        return self._send_frame(dst, tag, _lowp.dtype_name(arr.dtype),
                                shape, (payload,))

    def send_quant(self, dst: int, tag: str, chunk) -> int:
        """Send one block-quantized frame (a
        :class:`~tpu_dist_torch.collectives.quant.QuantChunk`): int8 payload +
        per-block float32 scales in ONE vectored ``sendmsg``, under the
        wire dtype name ``q8b{block}``.  Returns wire payload bytes sent
        (q + scales) — the compressed quantity obs counts as
        ``wire_bytes``."""
        scales = np.ascontiguousarray(chunk.scales, np.float32)
        q = np.ascontiguousarray(chunk.q, np.int8)
        return self._send_frame(
            dst, tag, f"q8b{chunk.scheme.block}", (q.size,),
            (memoryview(scales).cast("B"), memoryview(q).cast("B")))

    def _lane_stage(self, lane, parts, plan=None):
        """Pre-header SHM staging: copy whatever fits into the lane
        without blocking; returns the not-yet-staged remainders (sent
        after the header).  Everything that can fail here fails BEFORE the
        frame header leaves on TCP, which is what makes mid-stream lane
        failure recoverable — the caller degrades the frame (and the
        destination) to inline TCP instead of wedging the ring."""
        if plan is not None and plan.kind in ("conn-reset", "truncate"):
            # an injected lane breakage (netchaos shm surface): the
            # recovery under test is the TCP fallback, not an error
            raise ConnectionError(f"netchaos: injected shm lane {plan.kind}")
        if plan is not None and plan.kind == "slow-drip":
            # the lane transfer is a memcpy: a slow medium is the
            # equivalent stall up front
            time.sleep(sum(len(p) for p in parts) / max(1.0, plan.rate))
        rest = []
        for p in parts:
            if rest:
                rest.append(p)  # keep strict byte order
            elif len(p):
                done = lane.write_some(p)
                if done < len(p):
                    rest.append(p[done:])
        return rest

    def _degrade_lane(self, dst: int, err: BaseException) -> None:
        """Mid-stream SHM lane failure: drop the lane and pin this
        destination to inline TCP for the rest of the incarnation.  The
        established peer socket is untouched, so the frame (and the
        collective it belongs to) completes over TCP with identical
        bytes — degraded transport, bitwise-equal result.

        Deliberately NO ``unlink`` here, unlike the send-failure reap:
        the connection is ALIVE, so the lane announce may still be in
        flight toward the receiver's reader thread — yanking the name
        now would fail its attach (and with it the healthy connection).
        The receiver removes the name at attach as usual; only a
        receiver that dies before ever attaching leaves one named
        segment behind (the same bounded crash debris as ``close``)."""
        stale = self._shm_out.pop(dst, None)
        self._shm_tried[dst] = True
        if stale is not None:
            stale.close()
        self._obs("shm-lane", dst, role="degraded-to-tcp",
                  detail=repr(err))
        try:
            from ..utils.logging import log_event
            log_event("shm-lane-degraded", dst=dst, detail=repr(err))
        except Exception:
            pass

    def _send_frame(self, dst: int, tag: str, dtype_name: str, shape,
                    parts) -> int:
        """Shared outbound path for plain and quantized frames: one
        connection per destination, vectored send (or an SHM-lane payload
        with a TCP header, for co-located peers), optional payload
        checksum, deterministic network-fault injection, peer death
        diagnosed outside the send lock."""
        if dst == self.rank:
            raise ValueError("data plane does not deliver to self")
        parts = [memoryview(p).cast("B") for p in parts]
        plen = sum(len(p) for p in parts)
        send_err = None
        with self._out_lock(dst):
            sock = self._out.get(dst)
            try:
                if sock is None:
                    sock = self._connect(dst)
                    self._out[dst] = sock
                lane = self._maybe_lane(dst, sock) if plen else None
                # the checksum BEFORE the fault injection: netchaos
                # `corrupt` flips bits ON THE WIRE, which is what the
                # receiver's verification must catch
                wire_dtype = dtype_name
                trailer = b""
                if frame_crc_enabled():
                    wire_dtype = _CRC_MARK + dtype_name
                    trailer = _U32.pack(frame_checksum(parts))
                plan = None
                nc = _net_chaos()
                if nc is not None:
                    plan = nc.plan("shm" if lane is not None else "tcp",
                                   src=self.rank, dst=dst)
                if plan is not None:
                    if plan.kind == "partition":
                        # a rank-pair blackhole: the frame never leaves;
                        # the receiver's watchdog names the stalled hop
                        return plen
                    if plan.kind == "delay":
                        time.sleep(plan.delay)
                    elif plan.kind == "corrupt":
                        parts = [memoryview(p).cast("B") for p in
                                 nc.corrupt_parts(plan, parts)]
                if lane is not None:
                    try:
                        rest = self._lane_stage(lane, parts, plan)
                    except (OSError, TimeoutError) as lane_err:
                        self._degrade_lane(dst, lane_err)
                        lane = None
                        plan = None  # the fault WAS the lane's breakage:
                        # it must not fire again on the TCP fallback
                    else:
                        # payload FIRST (whatever fit without blocking),
                        # then header + checksum: by the time the
                        # receiver's reader parses the header, the bytes
                        # are already in the ring.  Only a frame
                        # overrunning the ring streams the remainder
                        # after the header (the receiver drains
                        # concurrently).
                        header = _encode_frame_header(
                            tag.encode(),
                            (_SHM_MARK + wire_dtype).encode(),
                            shape, plen) + trailer
                        _sendv(sock, header)
                        if rest:
                            timeout = _default_timeout()
                            abort = self._lane_abort(sock)
                            for p in rest:
                                lane.write(p, timeout=timeout,
                                           abort_check=abort)
                if lane is None:
                    header = _encode_frame_header(
                        tag.encode(), wire_dtype.encode(), shape,
                        plen) + trailer
                    if plan is not None and plan.kind in ("conn-reset",
                                                          "truncate"):
                        _inject_break(sock, header, parts, plan)
                    elif plan is not None and plan.kind == "slow-drip":
                        _sendv_paced(sock, header, parts, plan.rate)
                    else:
                        _sendv(sock, header, *parts)
            # tpudlint: disable=TD009  # stored in send_err and re-raised below, outside the send lock
            except PeerGoneError as e:
                send_err = e  # _connect diagnosed the peer; the obs-tail
                # enrichment still happens below, outside the lock
            except (OSError, TimeoutError) as e:
                self._out.pop(dst, None)
                stale = self._shm_out.pop(dst, None)
                self._shm_tried.pop(dst, None)
                if stale is not None:
                    # a reconnect announces a fresh lane — the receiver's
                    # read position in this one is unknowable.  Unlink too:
                    # the peer either attached already (name is gone,
                    # no-op) or is dead/never-attaching (reap the name)
                    stale.unlink()
                    stale.close()
                try:
                    if sock is not None:
                        sock.close()
                except OSError:
                    pass
                send_err = e  # diagnose outside the lock: gone_error's
                # obs-tail lookup is a store round-trip, and senders to
                # this dst must not queue behind a diagnostic
        if send_err is not None:
            detail = (send_err.detail if isinstance(send_err, PeerGoneError)
                      else repr(send_err))
            raise self.gone_error(dst, detail) from send_err
        return plen

    # -- receive -------------------------------------------------------------

    def _obs(self, op: str, peer: int, **fields) -> None:
        """Record a transport lifecycle event on the flight recorder
        (no-op when disarmed; must never raise into the reader threads)."""
        try:
            from ..obs.recorder import safe_record
        except Exception:
            return
        safe_record("transport", op, peer=peer, **fields)

    def gone_error(self, peer: int, detail: str = "") -> PeerGoneError:
        """A :class:`PeerGoneError` for ``peer``, enriched (when the flight
        recorder is armed) with the peer's last posted position from the
        store: the dead rank cannot speak for itself, but its obs tail can.
        Call outside any transport lock: the lookup is a store round trip.
        Under a role graph (:mod:`tpu_dist_torch.roles`) the peer is also
        named by role."""
        try:
            from ..roles.graph import role_label
            label = role_label(peer)
            if label:
                detail = (f"{detail}; role {label}" if detail
                          else f"role {label}")
        except Exception:
            pass
        try:
            from ..obs import hooks as _obs_hooks
            from ..obs import recorder as _obs_rec
            if _obs_rec.enabled():
                tail = _obs_hooks.fetch_tail(self._store, self.generation,
                                             peer)
                if tail is not None:
                    extra = f"peer's last obs: {_obs_hooks.render_tail(tail)}"
                    detail = f"{detail}; {extra}" if detail else extra
        except Exception:
            pass
        return PeerGoneError(peer, detail)

    def try_recv_array(self, src: int, tag: str):
        """Non-blocking: the next queued frame from ``(src, tag)`` or None."""
        with self._cv:
            return self._pop_locked(src, tag)

    def _pop_locked(self, src: int, tag: str):
        q = self._in_q.get((src, tag))
        if q:
            arr = q.popleft()
            if not q:
                del self._in_q[(src, tag)]
            return arr
        return None

    def peer_gone(self, src: int) -> Optional[str]:
        """Detail string if ``src``'s inbound connection died, else None."""
        with self._cv:
            return self._dead.get(src)

    def recv_array(self, src: int, tag: str,
                   timeout: Optional[float] = None) -> np.ndarray:
        """Block until a frame from ``(src, tag)`` arrives and return it.

        Frames from one peer arrive in send order (TCP + one connection per
        direction), so repeated calls with the same tag see the sender's
        chunk sequence in order.  Raises :class:`PeerGoneError` when the
        peer's connection died with frames still owed, ``TimeoutError``
        after ``timeout`` seconds (default ``TPU_DIST_DP_TIMEOUT``, 300).

        One wait loop exists — this delegates to :meth:`recv_array_dual`
        (with no alternate transport), so the peer-death / close / deadline
        handling cannot drift between the single- and dual-transport
        paths."""
        _, arr = self.recv_array_dual(src, tag, alt_check=None,
                                      timeout=timeout)
        return arr

    def recv_array_dual(self, src: int, tag: str, alt_check=None,
                        timeout: Optional[float] = None):
        """Wait for a frame from ``(src, tag)`` OR for ``alt_check()`` (a
        cheap poll of a second transport, e.g. a store key) to turn true.

        Returns ``("dataplane", arr)`` or ``("alt", None)``.  Frame
        arrival and peer death wake this *immediately* through the
        transport's condition variable; the alternate transport is polled
        between CV waits at an exponentially-backed-off interval (bounded
        at 50 ms), never while holding the CV — a store round-trip under
        the lock would stall every reader thread's frame delivery.  This
        replaces the old busy-poll loop in ``eager.recv`` (0.2 ms sleeps
        hammering both transports).  Raises :class:`PeerGoneError` /
        ``TimeoutError`` like :meth:`recv_array`."""
        if timeout is None:
            timeout = _default_timeout()
        deadline = (time.monotonic() + timeout) if timeout > 0 else None
        # with no alternate transport there is nothing to poll between CV
        # waits — park in long slices instead of the alt-poll backoff
        poll, poll_cap = (0.002, 0.05) if alt_check is not None \
            else (1.0, 1.0)
        while True:
            dead_detail = None
            with self._cv:
                slice_end = time.monotonic() + poll
                while True:
                    arr = self._pop_locked(src, tag)
                    if arr is not None:
                        return "dataplane", arr
                    if src in self._dead:
                        dead_detail = self._dead[src]
                        break
                    if self._closing:
                        raise RuntimeError("data plane closed during recv")
                    now = time.monotonic()
                    wake = slice_end if deadline is None \
                        else min(slice_end, deadline)
                    if wake - now <= 0:
                        break
                    self._cv.wait(wake - now)
            # outside the CV: consult the alternate transport / diagnose
            if alt_check is not None and alt_check():
                return "alt", None
            if dead_detail is not None:
                # the peer died — one last look at both sources (a frame
                # or key that landed between our check and the death
                # report still counts), then a named diagnosis
                with self._cv:
                    arr = self._pop_locked(src, tag)
                    named = self._dead_errs.get(src)
                if arr is not None:
                    return "dataplane", arr
                if isinstance(named, FrameCorruptError):
                    # the connection died because a frame failed its
                    # checksum: surface THAT diagnosis (src/tag/offset),
                    # not a generic peer-gone
                    raise named
                raise self.gone_error(src, dead_detail)
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"data-plane recv from rank {src} tag {tag!r} "
                    f"timed out after {timeout:.0f}s")
            poll = min(poll * 2, poll_cap)

    # -- lifecycle -----------------------------------------------------------

    def close(self, _at_exit: bool = False) -> None:
        if self._closing:
            return
        self._closing = True
        if not _at_exit:
            try:
                self._store.delete_key(self._addr_key(self.rank))
            except Exception:
                pass  # store may be down; the key is generation-scoped
            import atexit
            try:
                # an explicitly-closed (superseded-incarnation) DataPlane
                # must not stay pinned by its exit hook
                atexit.unregister(self.close)
            except Exception:
                pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._out_mu:
            socks = list(self._out.values())
            self._out.clear()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        for lane in (list(self._shm_out.values())
                     + list(self._shm_in.values())):
            # mappings only — deliberately NO unlink: the receiver removed
            # the name at attach, and unlinking a not-yet-attached lane
            # here would lose frames a clean exit must deliver (shm.py's
            # lifecycle note).  A receiver SIGKILLed before ever attaching
            # leaves one named segment behind — bounded crash debris.
            lane.close()
        self._shm_out.clear()
        self._shm_in.clear()
        with self._cv:
            # undelivered frames die with the incarnation; dropping them
            # here keeps a closed DataPlane from pinning megabytes of
            # queued ndarrays for the rest of the process
            self._in_q.clear()
            self._cv.notify_all()

    def __repr__(self):
        return (f"DataPlane(rank={self.rank}/{self.num_processes}, "
                f"addr={self.addr}, generation={self.generation})")


def _recv_exact_or_raise(conn, n: int) -> bytearray:
    buf = _recv_exact(conn, n)
    if buf is None:
        raise ConnectionError("connection closed mid-frame")
    return buf


def _decode_quant(dtype_name: str, shape, payload, plen: int):
    """Decode one ``q8b{block}`` frame (scales || int8 payload) into a
    :class:`~tpu_dist_torch.collectives.quant.QuantChunk`.  Both arrays wrap
    the receive buffer zero-copy; the ring dequantizes at the fold or
    forwards the chunk verbatim."""
    from .quant import QuantChunk, QuantScheme
    try:
        scheme = QuantScheme(int(dtype_name[3:]))
    except ValueError as e:
        raise ConnectionError(f"bad quant frame dtype {dtype_name!r}") from e
    if len(shape) != 1:
        raise ConnectionError(
            f"quant frame wants flat shape, got {shape}")
    n = int(shape[0])
    sbytes = 4 * scheme.scales_for(n)
    if plen != sbytes + n:
        raise ConnectionError(
            f"quant frame payload {plen}B does not match {n} elements at "
            f"block {scheme.block} ({sbytes}B scales + {n}B q)")
    view = memoryview(payload)
    return QuantChunk(np.frombuffer(view[sbytes:], np.int8),
                      np.frombuffer(view[:sbytes], np.float32), scheme)


# -- process-wide singleton ---------------------------------------------------

_dp: Optional[DataPlane] = None
_dp_mu = threading.Lock()


def get_data_plane(store, rank: int,
                   num_processes: int) -> Optional[DataPlane]:
    """The process's data plane, created on first use (None when disabled,
    single-process, or no store).  One per process per incarnation — the
    generation comes from ``TPU_DIST_RESTART_COUNT`` like every other
    incarnation-scoped key."""
    global _dp
    if store is None or num_processes <= 1:
        return None
    if os.environ.get("TPU_DIST_NO_DATAPLANE"):
        return None
    with _dp_mu:
        if _dp is not None and not _dp._closing:
            return _dp
        import importlib
        gen = importlib.import_module(
            "tpu_dist_torch.dist.rendezvous").generation()
        _dp = DataPlane(store, rank, num_processes, generation=gen)
        return _dp


def close_data_plane() -> None:
    """Tear down the process's data plane (called from
    ``tpu_dist_torch.dist.rendezvous.shutdown``; safe to call twice)."""
    global _dp
    with _dp_mu:
        if _dp is not None:
            _dp.close()
            _dp = None
