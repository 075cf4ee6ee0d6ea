"""tpu_dist_torch.serve — counterpart of ``tpu_dist.serve``: single-rank
continuous-batching LM serving.

- :class:`SlotEngine` (engine.py): a fixed pool of KV-cache slots with
  per-slot lengths; requests are admitted into free slots between decode
  iterations while the others keep decoding.
- :class:`Scheduler` (scheduler.py): bounded admission queue, background
  prompt staging, deadline-bounded batching window, drain and close.
- :class:`Frontend` (frontend.py): the serve wire (protocol v2),
  byte-compatible with the JAX package's, so either package's client
  drives either package's frontend.
- :class:`ServeClient` (client.py): streaming handles whose terminal state
  is always reached — tokens and done, or a NAMED error.
- :func:`random_key`: the key of a request's ``seed`` in the JAX package's
  random stream (:mod:`tpu_dist_torch.random`), which sampling draws from.

The gateway and the backend registry come with the launcher (ROADMAP A5);
multi-rank serving (sharded, disaggregated, prefix cache) with A9.
"""

from ..random import key as random_key
from .client import RequestFailedError, ServeClient, ServerGoneError
from .engine import (DeadlineExceededError, QueueFullError, Request,
                     RequestCancelledError, RequestHandle,
                     SchedulerClosedError, SchedulerDrainingError,
                     ServeError, SlotEngine, sample_tokens)
from .frontend import Frontend
from .scheduler import Scheduler

__all__ = ["SlotEngine", "Scheduler", "Frontend", "ServeClient", "Request",
           "RequestHandle", "ServeError", "QueueFullError",
           "SchedulerDrainingError", "SchedulerClosedError",
           "DeadlineExceededError", "RequestCancelledError",
           "RequestFailedError", "ServerGoneError", "sample_tokens",
           "random_key"]
