"""tpu_dist_torch.obs — collective flight recorder, cross-rank trace
timeline and hang diagnosis (counterpart of ``tpu_dist/obs``).

1. **Flight recorder** (:mod:`.recorder`): a per-rank ring buffer of
   structured events — every eager host collective (lockstep sequence
   number, reduce op, payload digest, transport path, start/end monotonic
   ns, user call-site, outcome), p2p send/recv, store client op, channel
   cursor move and heartbeat beat.  Armed with ``TPU_DIST_OBS=1`` (launcher
   ``--flight-recorder``); disarmed, a hook costs one env lookup.  The
   per-(op, transport) counters share its ingestion point.
2. **Crash and hang dumps, store tails** (:mod:`.hooks`): unhandled
   exceptions, SIGTERM, SIGUSR1 (the launcher's flush request) and process
   exit write the buffer to ``TPU_DIST_OBS_DIR``; each heartbeat re-posts a
   compact tail under ``tpu_dist/g{gen}/obs/{rank}``, so even a SIGKILLed
   rank leaves its last position behind for the supervisor's table and for
   the ``RankLostError`` / ``PeerGoneError`` messages.
3. **Timeline and diagnosis** (:mod:`.trace`, ``python -m
   tpu_dist_torch.obs``): the per-rank dumps merged into one Chrome
   ``trace_event`` timeline, and the hang named: which rank is behind, at
   which collective and call-site, and which ranks were already waiting.

The schema, keys and file names are the JAX package's: each package's
tools read the other's dumps.
"""

from . import hooks, recorder, trace
from .hooks import (collective_span, fetch_tail, install_from_env, note_path,
                    post_tail, render_tail)
from .recorder import (FlightRecorder, default_dump_dir, dump_now, dump_path,
                       enabled, get_recorder, obs_key, record_transport,
                       reset, reset_transport_counters, transport_counters)
from .trace import diagnose, merge_trace, read_dumps, render_diagnosis

__all__ = [
    "recorder", "hooks", "trace",
    "FlightRecorder", "enabled", "get_recorder", "reset", "dump_now",
    "record_transport", "transport_counters", "reset_transport_counters",
    "obs_key", "default_dump_dir", "dump_path",
    "collective_span", "note_path", "install_from_env", "post_tail",
    "fetch_tail", "render_tail",
    "read_dumps", "merge_trace", "diagnose", "render_diagnosis",
]
