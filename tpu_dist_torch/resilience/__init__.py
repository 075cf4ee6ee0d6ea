"""tpu_dist_torch.resilience — counterpart of ``tpu_dist.resilience``: so
far the heartbeat watchdog (``Heartbeat``, ``HeartbeatMonitor``,
``RankLostError``) that the launcher's ``--heartbeat_timeout`` and the
serving worker use, and the exit codes of the preemption protocol.  The
rest (chaos, elastic resharding, ``TrainState``) is ROADMAP A9.1."""

from .heartbeat import Heartbeat, HeartbeatMonitor, RankLostError, hb_key

# A worker exiting PREEMPTED_EXIT_CODE says "my rank is gone for good";
# GROW_EXIT_CODE says "capacity is back".  The values are the JAX package's
# (tpu_dist/resilience/chaos.py), so either package's supervisor reads
# either package's workers alike.
PREEMPTED_EXIT_CODE = 117
GROW_EXIT_CODE = 118

__all__ = ["Heartbeat", "HeartbeatMonitor", "RankLostError", "hb_key",
           "PREEMPTED_EXIT_CODE", "GROW_EXIT_CODE"]
