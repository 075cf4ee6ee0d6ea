"""Follower replica of the control-plane store (counterpart of
``tpu_dist/cluster/replica.py``, on the same wire ops).

A :class:`StoreFollower` owns a local replicating
:class:`~tpu_dist_torch.dist.store.PyTCPStoreServer` and keeps it
converged with the leader by tailing the leader's mutation log:

1. one ``_OP_SNAPSHOT`` at start (an atomic kv image and its sequence
   number);
2. then an ``_OP_LOG_SINCE`` poll every ``TPU_DIST_STORE_REPL_POLL``
   seconds (0.05), applying SET/DELETE/DELETE_PREFIX entries in the
   leader's order.  ADD never appears in the log: the leader logs it as a
   SET of its result, so replay is idempotent;
3. a truncated log (the follower fell further behind than the leader
   keeps) is answered with a re-snapshot flag, and the follower starts
   over from a fresh image: bounded memory on the leader, convergence on
   the follower.

The follower's server is live (and connectable) the whole time, so a
promotion is nothing but stopping the tail and pointing the endpoints file
at it; blocked GET/WAIT_GE waiters that reconnect land on a server whose
condition variable wakes them as the original leader's would.

Leader death is detected coarsely here (tail failures spanning
``down_after`` seconds set :attr:`leader_lost`); the node agent
(tpu_dist_torch/cluster/agent.py) combines it with lease freshness to run
the election.  The wire is the JAX package's, so a follower of either
package tails a leader of the other.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Optional, Tuple

from ..dist.store import (_OP_LOG_SINCE, _OP_SNAPSHOT, PyTCPStoreServer,
                          _PyClient)

__all__ = ["StoreFollower", "parse_snapshot", "parse_log"]


def parse_snapshot(body: bytes) -> Tuple[int, dict]:
    """Decode an ``_OP_SNAPSHOT`` reply into ``(seq, {key: value})``."""
    seq, count = struct.unpack_from("<qI", body)
    off, items = 12, {}
    for _ in range(count):
        (klen,) = struct.unpack_from("<I", body, off)
        off += 4
        key = body[off:off + klen].decode()
        off += klen
        (vlen,) = struct.unpack_from("<I", body, off)
        off += 4
        items[key] = body[off:off + vlen]
        off += vlen
    return seq, items


def parse_log(body: bytes):
    """Decode an ``_OP_LOG_SINCE`` reply: None when the leader asked for a
    re-snapshot (flag 1), else ``(leader_seq, [(seq, op, key, payload),
    ...])``."""
    if body[0] == 1:
        return None
    leader_seq, count = struct.unpack_from("<qI", body, 1)
    off, entries = 13, []
    for _ in range(count):
        seq, op, klen = struct.unpack_from("<qBI", body, off)
        off += 13
        key = body[off:off + klen].decode()
        off += klen
        (plen,) = struct.unpack_from("<I", body, off)
        off += 4
        entries.append((seq, op, key, body[off:off + plen]))
        off += plen
    return leader_seq, entries


class StoreFollower:
    """Tails a leader store into a live local replica server.

    ``pause()``/``resume()`` freeze the tail (the replication-lag tests put
    the follower behind a generation reap with them); ``promote()`` stops
    the tail for good and returns the replica server's address.
    :attr:`leader_lost` is set once tail polls have failed for
    ``down_after`` seconds in a row."""

    def __init__(self, leader_host: str, leader_port: int, port: int = 0,
                 poll: Optional[float] = None,
                 down_after: Optional[float] = None):
        self.leader_host, self.leader_port = leader_host, leader_port
        self.server = PyTCPStoreServer(port, replicate=True)
        self.port = self.server.port
        self._poll = (poll if poll is not None else float(
            os.environ.get("TPU_DIST_STORE_REPL_POLL", "0.05")))
        self.down_after = (down_after if down_after is not None else float(
            os.environ.get("TPU_DIST_STORE_DOWN_AFTER", "2.0")))
        self._client: Optional[_PyClient] = None
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._tail_mu = threading.Lock()  # held across each tail round
        self._promoted = threading.Event()
        self.leader_lost = threading.Event()
        self._first_fail: Optional[float] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def seq(self) -> int:
        return self.server.replication_seq()

    def start(self) -> "StoreFollower":
        self._client = _PyClient(self.leader_host, self.leader_port,
                                 timeout=10.0, follow_endpoints=False)
        self._snapshot()
        self._thread = threading.Thread(target=self._tail_loop, daemon=True,
                                        name="tpu_dist_torch-store-tail")
        self._thread.start()
        return self

    def _snapshot(self) -> None:
        seq, items = parse_snapshot(self._client.request(_OP_SNAPSHOT, ""))
        self.server.install_snapshot(seq, items)

    def _tail_once(self) -> None:
        parsed = parse_log(self._client.request(
            _OP_LOG_SINCE, "", struct.pack("<q", self.seq)))
        if parsed is None:  # fell behind the leader's log retention
            self._snapshot()
            return
        for seq, op, key, payload in parsed[1]:
            self.server.apply_mutation(seq, op, key, payload)

    def _tail_loop(self) -> None:
        while not self._stop.is_set() and not self._promoted.is_set():
            with self._tail_mu:
                if not self._paused.is_set():
                    try:
                        self._tail_once()
                        self._first_fail = None
                    except (OSError, RuntimeError):
                        # LOG_SINCE is at-most-once on the tail client, so
                        # every failure lands here; the leader is lost only
                        # once the outage spans down_after — one dropped
                        # connection is not a dead leader
                        now = time.monotonic()
                        if self._first_fail is None:
                            self._first_fail = now
                        elif now - self._first_fail >= self.down_after:
                            self.leader_lost.set()
            self._stop.wait(self._poll)

    def pause(self) -> None:
        # synchronous: a tail round in flight when the event is set could
        # still apply mutations that raced in at the leader, so wait on the
        # round's lock — after return the follower's image is frozen
        self._paused.set()
        with self._tail_mu:
            pass

    def resume(self) -> None:
        self._paused.clear()

    def wait_caught_up(self, seq: int, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while self.seq < seq:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        return True

    def _close_tail(self) -> None:
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._client is not None:
            self._client.close()
            self._client = None

    def promote(self) -> Tuple[str, int]:
        """Stop tailing: the replica server (already live) is now the
        leader.  Returns ``(host, port)`` for the endpoints file, which the
        caller publishes."""
        self._promoted.set()
        self._close_tail()
        return ("127.0.0.1", self.port)

    def stop(self) -> None:
        self._stop.set()
        self._close_tail()
        self.server.stop()

    def __enter__(self) -> "StoreFollower":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
