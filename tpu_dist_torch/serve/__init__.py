"""tpu_dist_torch.serve — counterpart of ``tpu_dist.serve``: continuous-
batching LM serving, single-rank and multi-rank.

- :class:`SlotEngine` (engine.py): a fixed pool of KV-cache slots with
  per-slot lengths; requests are admitted into free slots between decode
  iterations while the others keep decoding.
- :class:`Scheduler` (scheduler.py): bounded admission queue, background
  prompt staging, deadline-bounded batching window, drain and close.
- :class:`Frontend` (frontend.py): the serve wire (protocol v2),
  byte-compatible with the JAX package's, so either package's client
  drives either package's frontend; given a control-plane store it
  registers itself in the backend registry.
- :class:`Gateway` (frontend.py): the ``--serve`` role, one stable port in
  front of the registry's backends, surviving their restarts
  (``python -m tpu_dist_torch.serve gateway``).
- :class:`ServeClient` (client.py): streaming handles whose terminal state
  is always reached — tokens and done, or a NAMED error.
- tensor-parallel decode (sharded.py): a ``model-shard`` group holds one
  model between its ranks (heads and MLP columns split), combines each
  block's partial sums over the host data plane and stays in lockstep with
  no per-token broadcast; rank 0 leads (:class:`ShardedSlotEngine`), the
  others follow (:class:`ShardFollower`).
- disaggregated prefill/decode (disagg.py, kvtransfer.py, prefix.py):
  prefill and decode as separate role groups — prefill ranks ship each
  request's KV rows to its decode rank in CRC-sealed data-plane fragments,
  repeated prompt prefixes come from a content-verified
  :class:`PrefixCache` with only the suffix prefilled.
- :func:`random_key`: the key of a request's ``seed`` in the JAX package's
  random stream (:mod:`tpu_dist_torch.random`), which sampling draws from.
"""

from ..random import key as random_key
from .client import RequestFailedError, ServeClient, ServerGoneError
from .engine import (DeadlineExceededError, QueueFullError, Request,
                     RequestCancelledError, RequestHandle,
                     SchedulerClosedError, SchedulerDrainingError,
                     ServeError, SlotEngine, sample_tokens)
from .frontend import (BACKEND_KEY, BACKENDS_REG_PREFIX, BACKENDS_SEQ_KEY,
                       GATEWAY_KEY, ROLE_FRONTEND, ROLE_MODEL_SHARD,
                       BackendGoneError, Frontend, Gateway, list_backends,
                       register_backend, store_from_env)
from .scheduler import Scheduler
from .disagg import (PREFILL_QUEUE, ROLE_DECODE, ROLE_PREFILL, DisaggError,
                     DisaggScheduler, DisaggSlotEngine, PrefillWorker,
                     disagg_graph, kv_channel)
from .kvtransfer import KVTransfer, KVTransferError, kv_template
from .prefix import PrefixCache
from .sharded import (ShardConfigError, ShardedDecoder, ShardedLM,
                      ShardedParams, ShardedSlotEngine, ShardFollower,
                      ShardPlanError, shard_params)

__all__ = ["SlotEngine", "Scheduler", "Frontend", "Gateway", "ServeClient",
           "BackendGoneError", "BACKEND_KEY", "GATEWAY_KEY",
           "register_backend", "list_backends", "store_from_env", "Request",
           "RequestHandle", "ServeError", "QueueFullError",
           "SchedulerDrainingError", "SchedulerClosedError",
           "DeadlineExceededError", "RequestCancelledError",
           "RequestFailedError", "ServerGoneError", "sample_tokens",
           "random_key", "BACKENDS_SEQ_KEY", "BACKENDS_REG_PREFIX",
           "ROLE_FRONTEND", "ROLE_MODEL_SHARD",
           "ShardedLM", "ShardedDecoder", "ShardedSlotEngine",
           "ShardFollower", "ShardedParams", "shard_params",
           "ShardConfigError", "ShardPlanError",
           "ROLE_PREFILL", "ROLE_DECODE", "PREFILL_QUEUE", "kv_channel",
           "disagg_graph", "DisaggError", "DisaggSlotEngine",
           "DisaggScheduler", "PrefillWorker",
           "KVTransfer", "KVTransferError", "kv_template", "PrefixCache"]
