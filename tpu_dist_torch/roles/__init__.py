"""tpu_dist_torch.roles — role-based process graphs with typed channels
(counterpart of ``tpu_dist/roles``).

Named roles with per-role world sizes and restart policies, contiguous
global-rank spans with pre-built intra-role
:class:`~tpu_dist_torch.collectives.topology.SubGroup` collectives, and
typed store-registered, data-plane-carried channels between roles.

- :class:`RoleGraph` / :class:`Role` / :class:`ChannelSpec` — the
  validated graph spec (graph.py).
- :class:`Channel` — bounded MPMC queues and "latest" registers between
  roles, deadline-bounded with a named failure taxonomy (channel.py).
- :func:`init_role_graph` / :class:`RoleContext` — the per-process
  runtime: role accessors, the intra-role group, channel endpoints
  (runtime.py).
- :func:`spawn_graph` — the supervisor: per-role spawn, solo-vs-gang
  restart routing, heartbeat integration (launcher.py); the CLI
  spelling is ``python -m tpu_dist_torch.launch --roles learner:1,actor:4``.

The examples are :mod:`tpu_dist_torch.examples.actor_learner` and
:mod:`tpu_dist_torch.examples.param_server`.
"""

from .channel import (Channel, ChannelClosedError, ChannelError,
                      ChannelPeerGoneError, ChannelTimeoutError)
from .graph import (ChannelSpec, Role, RoleGraph, RoleGraphError,
                    current_graph, current_role, parse_roles_spec,
                    role_label)
from .launcher import local_ranks_of, spawn_graph
from .runtime import RoleContext, init_role_graph

__all__ = ["Role", "ChannelSpec", "RoleGraph", "RoleGraphError",
           "parse_roles_spec", "current_role", "current_graph",
           "role_label",
           "Channel", "ChannelError", "ChannelClosedError",
           "ChannelTimeoutError", "ChannelPeerGoneError",
           "RoleContext", "init_role_graph", "spawn_graph",
           "local_ranks_of"]
