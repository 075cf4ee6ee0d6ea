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
- :mod:`.reshard` — elastic world-size resharding of sharded checkpoints,
  from disk or pushed by a peer over the host data plane.

The network chaos layer (``TPU_DIST_NETCHAOS``) is ROADMAP A9.4.
``PREEMPTED_EXIT_CODE`` (117) and ``GROW_EXIT_CODE`` (118) are the JAX
package's, so either package's supervisor reads either package's workers.
"""

from .chaos import (GROW_EXIT_CODE, PREEMPTED_EXIT_CODE, Chaos, ChaosError,
                    Fault, active as active_chaos,
                    install as install_chaos,
                    install_from_env as install_chaos_from_env,
                    uninstall as uninstall_chaos)
from .heartbeat import Heartbeat, HeartbeatMonitor, RankLostError, hb_key
from .state import TrainState

__all__ = [
    "Heartbeat", "HeartbeatMonitor", "RankLostError", "hb_key",
    "TrainState",
    "Chaos", "ChaosError", "Fault", "active_chaos", "install_chaos",
    "install_chaos_from_env", "uninstall_chaos",
    "PREEMPTED_EXIT_CODE", "GROW_EXIT_CODE",
]
