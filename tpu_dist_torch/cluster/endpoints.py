"""The cluster endpoints file — how every store client finds the leader
(counterpart of ``tpu_dist/cluster/endpoints.py``, the same JSON).

One small JSON document on a path every process of the node shares (named
by ``TPU_DIST_STORE_ENDPOINTS``)::

    {"leader": "10.0.0.1:29501", "epoch": 2,
     "candidates": {"0": "10.0.0.1:29501", "1": "10.0.0.2:31044"}}

- ``leader`` is the address every Python store client dials; the client
  re-reads this file on every reconnect (tpu_dist_torch/dist/store.py),
  which is the whole of failover on the client's side: no new wire op.
- ``epoch`` grows by one on every promotion.  A client that loses an
  at-most-once op across an epoch change raises
  :class:`~tpu_dist_torch.dist.store.StoreFailoverError`, not a bare
  ``ConnectionError``.
- ``candidates`` records each node's follower replica (informative: the
  election reads the *replicated* candidate table, so that it works from
  the surviving replica alone).

Writes are atomic (``os.replace``), so a reader never sees a torn
document; a read that races a rewrite parses as None and the client keeps
its address for one more attempt.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional, Tuple

__all__ = ["ENDPOINTS_ENV", "write_endpoints", "read_endpoints",
           "leader_addr"]

ENDPOINTS_ENV = "TPU_DIST_STORE_ENDPOINTS"


def write_endpoints(path: str, leader: str, epoch: int,
                    candidates: Optional[Dict[int, str]] = None) -> None:
    """Atomically (re)write the endpoints file."""
    doc = {"leader": leader, "epoch": int(epoch),
           "candidates": {str(k): v for k, v in (candidates or {}).items()}}
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".endpoints-", dir=d)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_endpoints(path: str) -> Optional[dict]:
    """The parsed endpoints document, or None (a missing or torn file)."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or not doc.get("leader"):
        return None
    return doc


def leader_addr(path: str) -> Optional[Tuple[str, int]]:
    """The current leader as ``(host, port)``, or None."""
    doc = read_endpoints(path)
    if doc is None:
        return None
    host, _, port = str(doc["leader"]).rpartition(":")
    try:
        return (host, int(port)) if host else None
    except ValueError:
        return None
