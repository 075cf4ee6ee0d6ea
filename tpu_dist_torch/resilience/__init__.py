"""tpu_dist_torch.resilience — counterpart of ``tpu_dist.resilience``:
elastic fault tolerance for long-running gangs.

- :mod:`.heartbeat` — every rank publishes ``tpu_dist/hb/<generation>/<rank>``
  to the control-plane store (:class:`Heartbeat`); :class:`HeartbeatMonitor`
  turns a silent rank into a named :class:`RankLostError`.
- :mod:`.state` — :class:`TrainState`, the auto-resume hook over
  :mod:`tpu_dist_torch.checkpoint`: periodic saves, restore-``latest``
  after a supervised restart, heartbeat progress and chaos step hooks, from
  two calls in the loop; sharded (ZeRO) state resumes at another world
  size.
- :mod:`.chaos` — deterministic fault injection (``TPU_DIST_CHAOS``: kill
  rank r at step k, shrink/grow the elastic world, stall a heartbeat,
  drop or delay store requests).
- :mod:`.netchaos` — the network counterpart (``TPU_DIST_NETCHAOS``):
  rank/peer/node/surface-scoped partitions, delays, connection resets,
  truncations, bit flips and throttles at the data plane's frames, its SHM
  lanes, the store client and the serve wire; every fault ends in a named
  bounded error or a degraded path that completes bit for bit.
- :mod:`.reshard` — elastic world-size resharding of sharded checkpoints,
  from disk or pushed by a peer over the host data plane.

``PREEMPTED_EXIT_CODE`` (117) and ``GROW_EXIT_CODE`` (118) are the JAX
package's, so either package's supervisor reads either package's workers.
"""

from .chaos import (GROW_EXIT_CODE, PREEMPTED_EXIT_CODE, Chaos, ChaosError,
                    Fault, active as active_chaos,
                    install as install_chaos,
                    install_from_env as install_chaos_from_env,
                    uninstall as uninstall_chaos)
from .heartbeat import Heartbeat, HeartbeatMonitor, RankLostError, hb_key
from .netchaos import (NetChaos, NetFault, active as active_netchaos,
                       install as install_netchaos,
                       install_from_env as install_netchaos_from_env,
                       uninstall as uninstall_netchaos)
from .state import TrainState

__all__ = [
    "Heartbeat", "HeartbeatMonitor", "RankLostError", "hb_key",
    "TrainState",
    "Chaos", "ChaosError", "Fault", "active_chaos", "install_chaos",
    "install_chaos_from_env", "uninstall_chaos",
    "NetChaos", "NetFault", "active_netchaos", "install_netchaos",
    "install_netchaos_from_env", "uninstall_netchaos",
    "PREEMPTED_EXIT_CODE", "GROW_EXIT_CODE",
]
