"""Per-node cluster agent: leases, a store replica and the election
(counterpart of ``tpu_dist/cluster/agent.py``, the same keys and flags).

One :class:`NodeAgent` runs a node (inside the launcher, or as the
process ``python -m tpu_dist_torch.cluster.agent`` that the failover tests
SIGKILL).  Three small jobs:

- **membership and lease**: it registers the node's host-fingerprint
  record and refreshes ``tpu_dist/cluster/lease/{node}`` every
  ``lease_interval`` seconds (best-effort SETs: a flaky store degrades
  the liveness data, never the agent);
- **replica**: a candidate node runs a
  :class:`~tpu_dist_torch.cluster.replica.StoreFollower` and publishes its
  address under ``tpu_dist/cluster/replica/{node}`` — which replicates, so
  the candidate table outlives the leader;
- **election**: a raw-socket watchdog probes the leader every
  ``lease_ttl/4``; once probes have failed for ``lease_ttl`` seconds (or
  the follower's tail flags the leader lost) the agent elects from its
  LOCAL replica: a candidate is live iff its lease is within ``lease_ttl``
  of the newest lease in the table (no clock agreement), and the lowest
  live node id among the replicated candidates wins.  No Raft: one
  deterministic rule over identically replicated inputs.  The winner
  promotes its follower and atomically rewrites the endpoints file at
  ``epoch + 1``; every other client re-resolves on its next reconnect.

Knobs: ``TPU_DIST_CLUSTER_LEASE_INTERVAL`` (1.0 s),
``TPU_DIST_CLUSTER_LEASE_TTL`` (5.0 s), ``TPU_DIST_STORE_REPL_POLL`` /
``TPU_DIST_STORE_DOWN_AFTER`` (the replica's tail cadence and outage
threshold).  The agent publishes its replica as ``127.0.0.1:<port>``, as
the JAX package's does, so agents of both packages meet in one cluster.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import threading
import time
from typing import Callable, Optional

from ..dist.store import PyTCPStoreServer, TCPStore
from . import endpoints as _ep
from . import membership as _mb
from .replica import StoreFollower

__all__ = ["NodeAgent", "main"]


def _log(event: str, **fields) -> None:
    try:
        from ..utils.logging import log_event
        log_event(event, **fields)
    except Exception:
        pass


class NodeAgent:
    """The per-node control-plane sidecar (the module docstring's
    protocol)."""

    def __init__(self, node_id: int, endpoints_path: str, *,
                 follower: Optional[StoreFollower] = None, nproc: int = 0,
                 lease_interval: Optional[float] = None,
                 lease_ttl: Optional[float] = None,
                 on_promote: Optional[Callable[[str, int], None]] = None):
        self.node_id = int(node_id)
        self.endpoints_path = endpoints_path
        self.follower = follower
        self.nproc = int(nproc)
        self.lease_interval = (lease_interval if lease_interval is not None
                               else float(os.environ.get(
                                   "TPU_DIST_CLUSTER_LEASE_INTERVAL", "1.0")))
        self.lease_ttl = (lease_ttl if lease_ttl is not None
                          else float(os.environ.get(
                              "TPU_DIST_CLUSTER_LEASE_TTL", "5.0")))
        self.on_promote = on_promote
        self.is_leader = threading.Event()  # set after a won election
        self._stop = threading.Event()
        self._store: Optional[TCPStore] = None
        self._threads = []

    def start(self) -> "NodeAgent":
        # the agent's own client rides a failover like every worker's
        os.environ.setdefault(_ep.ENDPOINTS_ENV, self.endpoints_path)
        addr = _ep.leader_addr(self.endpoints_path)
        if addr is None:
            raise RuntimeError(
                f"no leader in endpoints file {self.endpoints_path!r}")
        self._store = TCPStore(addr[0], addr[1], timeout=30.0)
        _mb.register_node(self._store, self.node_id, self.nproc)
        if self.follower is not None:
            self._store.set(_mb.replica_key(self.node_id),
                            f"127.0.0.1:{self.follower.port}")
        _mb.publish_lease(self._store, self.node_id)
        loops = [self._lease_loop]
        if self.follower is not None:
            loops.append(self._watchdog)
        for fn in loops:
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"tpu_dist_torch-agent-{fn.__name__}")
            t.start()
            self._threads.append(t)
        return self

    # -- leases ---------------------------------------------------------------

    def _lease_loop(self) -> None:
        while not self._stop.wait(self.lease_interval):
            try:
                _mb.publish_lease(self._store, self.node_id)
            except Exception:
                pass  # liveness data degrades; the agent never dies of it

    # -- the leader watchdog and the election ---------------------------------

    def _probe_leader(self) -> bool:
        addr = _ep.leader_addr(self.endpoints_path)
        if addr is None:
            return False
        if self.is_leader.is_set():
            return True  # it is us
        try:
            # a raw dial, NOT a client request: the probe must not ride the
            # client's reconnect backoff, which would stretch detection
            with socket.create_connection(addr, timeout=0.5):
                return True
        except OSError:
            return False

    def _watchdog(self) -> None:
        interval = max(0.05, self.lease_ttl / 4.0)
        down_since: Optional[float] = None
        epoch0 = self._epoch()
        while not self._stop.wait(interval):
            if self.is_leader.is_set():
                return
            if self._epoch() != epoch0:
                # another node promoted: follow the new leader
                epoch0 = self._epoch()
                down_since = None
                continue
            alive = self._probe_leader()
            tail_lost = (self.follower is not None
                         and self.follower.leader_lost.is_set())
            now = time.monotonic()
            if alive and not tail_lost:
                down_since = None
                continue
            if down_since is None:
                down_since = now
            if now - down_since >= self.lease_ttl or tail_lost:
                self._elect()
                down_since = None
                epoch0 = self._epoch()

    def _epoch(self) -> int:
        doc = _ep.read_endpoints(self.endpoints_path)
        return int(doc.get("epoch", 0)) if doc else -1

    def _elect(self) -> None:
        """The deterministic election from LOCAL replica state (the leader
        is dead: the wire is no option)."""
        if self.follower is None:
            return
        kv = self.follower.server.snapshot_items("tpu_dist/cluster/")
        leases = _mb.read_leases({k: v for k, v in kv.items()
                                  if k.startswith(_mb.LEASE_PREFIX)})
        replicas = {int(k[len(_mb.REPLICA_PREFIX):]): v.decode()
                    for k, v in kv.items()
                    if k.startswith(_mb.REPLICA_PREFIX)}
        candidates = sorted(replicas) or [self.node_id]
        live = _mb.live_nodes(leases, self.lease_ttl)
        live.add(self.node_id)  # I am demonstrably alive
        live_candidates = [n for n in candidates if n in live]
        winner = min(live_candidates or candidates)
        _log("store-election", node=self.node_id, winner=winner,
             candidates=candidates, live=sorted(live))
        if winner != self.node_id:
            return  # the winner publishes; our clients re-resolve
        host, port = self.follower.promote()
        epoch = self._epoch() + 1
        _ep.write_endpoints(self.endpoints_path, f"{host}:{port}", epoch,
                            candidates=replicas)
        self.is_leader.set()
        _log("store-failover-promoted", node=self.node_id,
             leader=f"{host}:{port}", epoch=epoch)
        if self.on_promote is not None:
            try:
                self.on_promote(host, port)
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._store is not None:
            self._store.close()
            self._store = None

    def __enter__(self) -> "NodeAgent":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- the standalone agent process ------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.cluster.agent",
        description="per-node control-plane agent: hosts the store leader "
                    "(--lead) or a follower replica, publishes leases, and "
                    "runs the failover election")
    p.add_argument("--node_id", type=int, required=True)
    p.add_argument("--endpoints", required=True,
                   help="shared endpoints file path")
    p.add_argument("--lead", action="store_true",
                   help="host the leader store and write the initial "
                        "endpoints file (epoch 0)")
    p.add_argument("--port", type=int, default=0,
                   help="leader/replica server port (0 = free port)")
    p.add_argument("--nproc", type=int, default=0,
                   help="this node's worker capacity (membership record)")
    p.add_argument("--advertise", default="127.0.0.1",
                   help="host address peers dial")
    p.add_argument("--ready_file", default=None,
                   help="write a JSON readiness marker once serving")
    args = p.parse_args(argv)

    os.environ[_ep.ENDPOINTS_ENV] = args.endpoints
    follower = None
    server = None
    if args.lead:
        server = PyTCPStoreServer(args.port, replicate=True)
        _ep.write_endpoints(args.endpoints,
                            f"{args.advertise}:{server.port}", 0)
        agent = NodeAgent(args.node_id, args.endpoints, nproc=args.nproc)
        agent.is_leader.set()
        agent.start()
        port = server.port
    else:
        addr = None
        deadline = time.monotonic() + 30.0
        while addr is None and time.monotonic() < deadline:
            addr = _ep.leader_addr(args.endpoints)
            if addr is None:
                time.sleep(0.1)
        if addr is None:
            print(f"no leader appeared in {args.endpoints}", flush=True)
            return 2
        follower = StoreFollower(addr[0], addr[1], port=args.port).start()
        agent = NodeAgent(args.node_id, args.endpoints, follower=follower,
                          nproc=args.nproc)
        agent.start()
        port = follower.port
    if args.ready_file:
        with open(args.ready_file, "w", encoding="utf-8") as f:
            json.dump({"node": args.node_id, "port": port,
                       "lead": bool(args.lead)}, f)
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *a: done.set())
    print(f"tpu_dist_torch cluster agent ready node={args.node_id} "
          f"port={port} lead={bool(args.lead)}", flush=True)
    # the agent parks here for its whole life, in bounded waits
    while not done.wait(1.0):
        pass
    agent.stop()
    if follower is not None:
        follower.stop()
    if server is not None:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
