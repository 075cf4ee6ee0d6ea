"""Shared-memory intra-host payload lane for the host data plane — the
port's copy of ``tpu_dist/collectives/shm.py``.

Each directed co-located pair (same host fingerprint,
:mod:`.topology`) gets a single-producer/single-consumer byte ring in a
``multiprocessing.shared_memory`` segment; frame *payloads* move through it
as two memcpys, while frame headers, ordering, liveness and generation
fencing stay on the TCP connection (:mod:`.transport`): the sender marks
the dtype name with ``&`` to say "the payload is in the lane".  Two
monotonic u64 counters (written, read; separate cache lines) give
backpressure, and a sender resumes a frame larger than the ring as the
receiver frees bytes.  Both sides poll an ``abort_check`` (a peek at the
TCP socket) while they wait, so a peer that dies mid-frame is a named
``ConnectionError``, never a hang.  The transport stages a frame's payload
before its header leaves, so a lane failure at staging time sends that
frame over TCP instead, with the same bytes.

Env knobs: ``TPU_DIST_SHM`` (``auto`` by default; ``0`` disables),
``TPU_DIST_SHM_RING`` (ring bytes, 8 MiB by default).  Lane names carry the
generation and the creator's pid (``tpdp_g{gen}_{pid}_{hex}``), so a
restarted incarnation never attaches a stale ring; the receiver unlinks the
name at attach, so a crashed pair leaves nothing in ``/dev/shm``.
"""

from __future__ import annotations

import os
import secrets
import time
from typing import Callable, Optional

import numpy as np

__all__ = ["ShmLane", "shm_enabled", "ring_capacity"]

# counter offsets (separate cache lines) + start of the data ring
_W_OFF = 0
_R_OFF = 64
_DATA_OFF = 128

_DEF_RING = 8 * 1024 * 1024


def shm_enabled() -> bool:
    """Whether SHM lanes may come up for co-located peers
    (``TPU_DIST_SHM``: ``auto``/``1`` on, ``0`` off).  Read per send so
    benchmarks can A/B the transport without rebuilding the DataPlane."""
    return os.environ.get("TPU_DIST_SHM", "auto").strip().lower() not in (
        "0", "off", "false", "no")


def ring_capacity() -> int:
    try:
        cap = int(os.environ.get("TPU_DIST_SHM_RING", str(_DEF_RING)))
    except ValueError:
        cap = _DEF_RING
    return max(4096, cap)


def _np_u64(buf, off: int) -> np.ndarray:
    return np.frombuffer(buf, dtype=np.uint64, count=1, offset=off)


class ShmLane:
    """One directed SPSC byte stream through a shared-memory segment.

    The sender constructs with ``create=True`` (it owns the segment and
    unlinks it at close); the receiver attaches by name.  ``write`` and
    ``read_into`` are blocking with deadline + abort polling; each side
    must be driven by exactly one thread (the data plane guarantees this:
    sends hold the per-destination lock, reads happen on the one reader
    thread of the inbound connection)."""

    def __init__(self, name: Optional[str] = None, capacity: int = 0,
                 create: bool = False, generation: int = 0):
        from multiprocessing import shared_memory
        self.owner = bool(create)
        if create:
            capacity = int(capacity) or ring_capacity()
            name = (f"tpdp_g{generation}_{os.getpid()}_"
                    f"{secrets.token_hex(4)}")
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=_DATA_OFF + capacity)
            self._shm.buf[:_DATA_OFF] = b"\x00" * _DATA_OFF
            # the lane owns its own lifecycle (see below): keep the
            # resource tracker out of it, or the creator's exit would
            # unlink a name a not-yet-attached receiver still needs
            self._untrack()
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            # the name's one job — letting this attach find the segment —
            # is done: remove it NOW.  Both mappings stay valid, in-flight
            # frames survive a sender that exits right after sending
            # (the TCP-buffer delivery semantic peers rely on), and a
            # SIGKILLed pair leaves no /dev/shm debris.  CPython 3.8-3.12
            # auto-registers attachments with the resource tracker;
            # unlink() (shm_unlink + unregister) balances that too.
            try:
                self._shm.unlink()
            except Exception:
                pass  # already unlinked (double announce / re-attach race)
            # ring capacity comes from the CREATOR's announce: both sides
            # must wrap at the same modulus, and platforms may page-round
            # the mapped segment size — recomputing from self._shm.size
            # here would silently corrupt payloads at wraparound
            capacity = int(capacity) or (self._shm.size - _DATA_OFF)
        self.name = self._shm.name.lstrip("/")
        self.capacity = int(capacity)
        buf = self._shm.buf
        self._w = _np_u64(buf, _W_OFF)
        self._r = _np_u64(buf, _R_OFF)
        self._data = np.frombuffer(buf, dtype=np.uint8, offset=_DATA_OFF,
                                   count=self.capacity)
        self._closed = False

    # -- ring I/O ------------------------------------------------------------

    def _views(self):
        """Local refs to the mapped views — taken once per call so a
        concurrent close() (which nulls the attributes before unmapping)
        cannot yank them mid-loop; a ref held here keeps the mapping
        alive, and the ``_closed`` flag ends the loop at its next check."""
        data, w, r = self._data, self._w, self._r
        if data is None:
            raise ConnectionError(f"shm lane {self.name} closed")
        return data, w, r

    def _copy_in(self, data, pos: int, src: np.ndarray) -> None:
        lo = pos % self.capacity
        first = min(src.size, self.capacity - lo)
        data[lo:lo + first] = src[:first]
        if first < src.size:  # wrap
            data[:src.size - first] = src[first:]

    def _copy_out(self, data, pos: int, dst: np.ndarray) -> None:
        lo = pos % self.capacity
        first = min(dst.size, self.capacity - lo)
        dst[:first] = data[lo:lo + first]
        if first < dst.size:
            dst[first:] = data[:dst.size - first]

    def _park(self, spun: int, detail: str, deadline: float,
              abort_check: Optional[Callable[[], Optional[str]]]) -> int:
        """One wait iteration while the ring has no room/data: spin a few
        rounds (the common case — the peer is actively streaming), then
        sleep-poll, checking peer death and the deadline."""
        if spun < 200:
            return spun + 1
        if abort_check is not None:
            why = abort_check()
            if why:
                raise ConnectionError(f"shm lane {self.name}: {why}")
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"shm lane {self.name}: peer made no progress before the "
                f"deadline (TPU_DIST_DP_TIMEOUT)")
        time.sleep(0.0002)
        return spun

    def write_some(self, payload) -> int:
        """Non-blocking write: copy as much of ``payload`` as the ring has
        room for, return the number of bytes written.  The send path uses
        this to stage a frame's payload BEFORE its header goes out on the
        socket — the receiver then finds the bytes already in the ring and
        never parks on a frame the sender is still copying."""
        src = np.frombuffer(memoryview(payload).cast("B"), dtype=np.uint8)
        if self._closed:
            raise ConnectionError(f"shm lane {self.name} closed")
        data, wctr, rctr = self._views()
        w = int(wctr[0])
        space = self.capacity - (w - int(rctr[0]))
        chunk = min(space, src.size)
        if chunk <= 0:
            return 0
        self._copy_in(data, w, src[:chunk])
        wctr[0] = w + chunk  # counter advances AFTER the bytes land
        return chunk

    def write(self, payload, timeout: float,
              abort_check: Optional[Callable[[], Optional[str]]] = None
              ) -> None:
        """Stream ``payload`` (a bytes-like) into the ring, blocking for
        space; partially written frames resume as the reader frees bytes."""
        src = np.frombuffer(memoryview(payload).cast("B"), dtype=np.uint8)
        deadline = time.monotonic() + timeout
        done, n, spun = 0, src.size, 0
        while done < n:
            wrote = self.write_some(src[done:])
            if wrote == 0:
                spun = self._park(spun, "peer stopped draining the ring",
                                  deadline, abort_check)
                continue
            spun = 0
            done += wrote

    def read_into(self, out: bytearray, timeout: float,
                  abort_check: Optional[Callable[[], Optional[str]]] = None
                  ) -> None:
        """Fill ``out`` from the ring, blocking until the writer has
        produced enough bytes; frees space as it consumes."""
        dst = np.frombuffer(out, dtype=np.uint8)
        deadline = time.monotonic() + timeout
        done, n, spun = 0, dst.size, 0
        while done < n:
            if self._closed:
                raise ConnectionError(f"shm lane {self.name} closed")
            data, wctr, rctr = self._views()
            r = int(rctr[0])
            avail = int(wctr[0]) - r
            if avail <= 0:
                spun = self._park(spun, "peer died mid-frame", deadline,
                                  abort_check)
                continue
            spun = 0
            chunk = min(avail, n - done)
            self._copy_out(data, r, dst[done:done + chunk])
            rctr[0] = r + chunk  # free the span only after the copy
            done += chunk

    # -- lifecycle -----------------------------------------------------------

    def _untrack(self) -> None:
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(
                getattr(self._shm, "_name", None)
                or "/" + self._shm.name.lstrip("/"), "shared_memory")
        except Exception:
            pass

    def unlink(self) -> None:
        """Remove the segment's name (creator-side, for lanes whose
        announce never reached the peer — the receiver otherwise unlinks
        at attach)."""
        try:
            self._shm.unlink()
        except Exception:
            pass

    def close(self) -> None:
        """Drop this side's mapping.  Deliberately NO unlink here: the
        receiver removed the name at attach; unlinking on the creator's
        close would race a receiver that has the announce in flight but
        has not attached yet (losing frames a clean sender exit must
        deliver)."""
        if self._closed:
            return
        self._closed = True
        # numpy views pin the mmap'd buffer; drop them before close()
        self._w = self._r = self._data = None
        try:
            self._shm.close()
        except Exception:
            pass

    def __repr__(self):
        return (f"ShmLane({self.name!r}, cap={self.capacity}, "
                f"{'owner' if self.owner else 'attached'})")
