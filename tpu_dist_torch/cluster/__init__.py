"""tpu_dist_torch.cluster — the multi-node control plane (counterpart of
``tpu_dist.cluster``, on the same wire, keys and files, so agents,
launchers and clients of both packages meet in one cluster).

Removes the store as a single point of failure and lifts the one-node
limits on ``--elastic_world`` and ``--roles``:

- :mod:`.endpoints` — the atomic endpoints file every client re-resolves
  the leader from (``TPU_DIST_STORE_ENDPOINTS``);
- :mod:`.replica` — :class:`StoreFollower`, a live replica tailing the
  leader's mutation log, with snapshot catch-up;
- :mod:`.agent` — :class:`NodeAgent`, the per-node sidecar (leases,
  membership, the leader watchdog, the deterministic election); also a
  process of its own, ``python -m tpu_dist_torch.cluster.agent``;
- :mod:`.membership` — node records, the cluster-wide elastic plan (which
  node's ranks drop, in host-fingerprint order) and role-placement
  validation.

Everything here is host code on the Python store wire; nothing touches the
card.
"""

from ..dist.store import StoreFailoverError
from .agent import NodeAgent
from .endpoints import (ENDPOINTS_ENV, leader_addr, read_endpoints,
                        write_endpoints)
from .membership import (elastic_plan, live_nodes, publish_lease,
                         read_nodes, register_node, validate_placement)
from .replica import StoreFollower

__all__ = ["StoreFailoverError", "NodeAgent", "StoreFollower",
           "ENDPOINTS_ENV", "write_endpoints", "read_endpoints",
           "leader_addr", "register_node", "read_nodes", "publish_lease",
           "live_nodes", "elastic_plan", "validate_placement"]
