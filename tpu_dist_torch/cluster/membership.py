"""Cross-launcher membership and the cluster-wide elastic decision
(counterpart of ``tpu_dist/cluster/membership.py``, the same keys).

Every launcher (or node agent) registers its node under
``tpu_dist/cluster/nodes/{node_id}``: a JSON record with the node's host
fingerprint (tpu_dist_torch/collectives/topology.py), process capacity and
node class.  Records are cluster-lifetime state, not generation-scoped:
they outlive restarts, so the elastic agreement of round N+1 can still
order nodes that ran nothing in round N.

An elastic shrink or grow across launchers is a *cluster decision*: after
a round ends every launcher publishes what happened on its node
(``tpu_dist/elastic/count/{rnd}/{node}``), then reads every node's counts
and runs the SAME pure function (:func:`elastic_plan`) over the same
store-agreed inputs — so every launcher agrees, with no coordinator, which
node's ranks drop and at which base rank each surviving node starts.  Node
order is host-fingerprint order (ties by node id), the order the topology
layer gives hosts.

Role placement (``--roles`` with ``@node`` pins) is validated against the
same cluster with :func:`validate_placement`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

from ..collectives.topology import host_fingerprint

__all__ = ["NODES_PREFIX", "LEASE_PREFIX", "REPLICA_PREFIX", "node_key",
           "lease_key", "replica_key", "register_node", "read_nodes",
           "publish_lease", "read_leases", "live_nodes",
           "elastic_count_key", "publish_elastic_counts",
           "gather_elastic_counts", "elastic_plan", "validate_placement"]

# cluster-lifetime namespaces: they outlive every generation on purpose
# (membership and leadership are cluster state)
NODES_PREFIX = "tpu_dist/cluster/nodes/"
LEASE_PREFIX = "tpu_dist/cluster/lease/"
REPLICA_PREFIX = "tpu_dist/cluster/replica/"


def node_key(node_id: int) -> str:
    return f"{NODES_PREFIX}{int(node_id)}"


def lease_key(node_id: int) -> str:
    return f"{LEASE_PREFIX}{int(node_id)}"


def replica_key(node_id: int) -> str:
    return f"{REPLICA_PREFIX}{int(node_id)}"


def register_node(store, node_id: int, nproc: int,
                  node_class: Optional[str] = None) -> dict:
    """Publish this node's membership record (an idempotent re-publish)."""
    rec = {"node": int(node_id),
           "host": host_fingerprint(),
           "nproc": int(nproc),
           "class": node_class or os.environ.get("TPU_DIST_NODE_CLASS",
                                                 "default")}
    store.set(node_key(node_id), json.dumps(rec).encode())
    return rec


def read_nodes(store, nnodes: int) -> Dict[int, dict]:
    """The registered membership records (missing nodes are absent)."""
    out = {}
    for n in range(nnodes):
        if store.check(node_key(n)):
            try:
                out[n] = json.loads(store.get(node_key(n)).decode())
            except (ValueError, ConnectionError):
                pass
    return out


def publish_lease(store, node_id: int) -> None:
    """Refresh this node's liveness lease, stamped with the wall clock;
    freshness is judged against the newest lease in the table, so clocks
    need only tick, not agree."""
    store.set(lease_key(node_id),
              json.dumps({"node": int(node_id), "t": time.time()}).encode())


def read_leases(items: Dict[str, bytes]) -> Dict[int, float]:
    """The lease table from a raw kv map (a replica's
    ``snapshot_items(LEASE_PREFIX)``)."""
    out = {}
    for raw in items.values():
        try:
            rec = json.loads(raw.decode())
            out[int(rec["node"])] = float(rec["t"])
        except (ValueError, KeyError, TypeError):
            pass
    return out


def live_nodes(leases: Dict[int, float], ttl: float) -> set:
    """Nodes whose lease is within ``ttl`` of the NEWEST lease: logical
    freshness, a node judged against its peers' clocks, not the judge's."""
    if not leases:
        return set()
    newest = max(leases.values())
    return {n for n, t in leases.items() if newest - t <= ttl}


# -- the cluster-wide elastic agreement ---------------------------------------


def elastic_count_key(rnd: int, node_id: int) -> str:
    return f"tpu_dist/elastic/count/{rnd}/{int(node_id)}"


def publish_elastic_counts(store, rnd: int, node_id: int, *, nproc: int,
                           full_nproc: int, preempted: int,
                           grow: bool) -> None:
    """Publish what happened on this node in round ``rnd``: how many ranks
    it ran, how many were preempted (exit 117) and whether one asked to
    grow (exit 118)."""
    store.set(elastic_count_key(rnd, node_id),
              json.dumps({"nproc": int(nproc),
                          "full_nproc": int(full_nproc),
                          "preempted": int(preempted),
                          "grow": bool(grow)}).encode())


def gather_elastic_counts(store, rnd: int, nnodes: int,
                          timeout: float) -> Dict[int, dict]:
    """Every node's counts for round ``rnd`` (blocks until all ``nnodes``
    have published, or raises TimeoutError)."""
    store.wait([elastic_count_key(rnd, n) for n in range(nnodes)],
               timeout=timeout)
    return {n: json.loads(store.get(elastic_count_key(rnd, n)).decode())
            for n in range(nnodes)}


def elastic_plan(counts: Dict[int, dict], records: Dict[int, dict],
                 lo: int, hi: int
                 ) -> Optional[Dict[int, Tuple[int, int]]]:
    """The cluster's elastic decision: ``{node: (base_rank, nproc)}``.

    Pure and deterministic over store-agreed inputs: every launcher runs it
    and lands on the same plan.  None when the world should NOT re-form
    elastically (nothing changed, or the survivors fall below ``lo``: the
    caller then takes an ordinary budgeted full-world restart).

    - shrink: each node keeps ``nproc - preempted`` ranks (a node may drop
      to 0 and idle until a later grow);
    - grow (no preemption): every node returns to its full capacity,
      clamped so that the total never exceeds ``hi``;
    - base ranks: contiguous spans in host-fingerprint order, ties by node
      id — so WHICH node's ranks drop is never one launcher's opinion."""
    if not counts:
        return None
    total_pre = sum(c.get("preempted", 0) for c in counts.values())
    any_grow = any(c.get("grow") for c in counts.values())
    cur_world = sum(c.get("nproc", 0) for c in counts.values())
    new_nproc: Dict[int, int] = {}
    if total_pre > 0:
        for n, c in counts.items():
            new_nproc[n] = max(0, c.get("nproc", 0) - c.get("preempted", 0))
    elif any_grow:
        budget = hi
        for n in sorted(counts, key=lambda m: (_host_of(records, m), m)):
            full = counts[n].get("full_nproc", counts[n].get("nproc", 0))
            new_nproc[n] = min(full, budget)
            budget -= new_nproc[n]
    else:
        return None
    total = sum(new_nproc.values())
    if total < lo or total == cur_world:
        return None
    plan: Dict[int, Tuple[int, int]] = {}
    base = 0
    for n in sorted(new_nproc, key=lambda m: (_host_of(records, m), m)):
        plan[n] = (base, new_nproc[n])
        base += new_nproc[n]
    return plan


def _host_of(records: Dict[int, dict], node_id: int) -> str:
    rec = records.get(node_id) or {}
    return str(rec.get("host") or f"~unregistered/{node_id}")


# -- role placement -------------------------------------------------------------


def validate_placement(graph, nnodes: int) -> None:
    """Every ``@node`` pin of a role graph must name a node of the cluster.
    Raises ``ValueError`` naming the role: a pin that cannot be met fails
    the launch instead of landing the role on node 0."""
    for role in graph.roles:
        node = getattr(role, "node", None)
        if node is not None and not 0 <= node < nnodes:
            raise ValueError(
                f"role {role.name!r} is pinned to node {node} but the "
                f"cluster has {nnodes} node(s) (0..{nnodes - 1})")
