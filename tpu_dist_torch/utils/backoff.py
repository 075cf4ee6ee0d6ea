"""Bounded exponential backoff under an overall deadline — counterpart of
``tpu_dist/utils/backoff.py``: the one retry shape of the reconnect paths
(the store client's dial, the gateway's backend dial).  A dead peer is a
named, bounded error; a restarting one a transparent retry."""

from __future__ import annotations

import time
from typing import Callable, Tuple, Type

__all__ = ["retry_call", "BackoffDeadlineError"]


class BackoffDeadlineError(TimeoutError):
    """Every retry of an operation failed before its overall deadline;
    ``last`` is the final attempt's exception (also the ``__cause__``),
    ``attempts`` how many were made."""

    def __init__(self, what: str, timeout: float, attempts: int,
                 last: BaseException):
        self.what = what
        self.timeout = float(timeout)
        self.attempts = int(attempts)
        self.last = last
        super().__init__(
            f"{what}: still failing after {timeout:.1f}s "
            f"({attempts} attempt{'s' if attempts != 1 else ''}, "
            f"last error: {last!r})")


def retry_call(fn: Callable[[], object], timeout: float,
               what: str = "operation", base: float = 0.05, cap: float = 2.0,
               retry_on: Tuple[Type[BaseException], ...] = (
                   OSError, TimeoutError)):
    """Call ``fn`` until it succeeds or ``timeout`` seconds pass: a failure
    of a ``retry_on`` type sleeps ``base`` doubling to ``cap`` (clipped to
    the time left) and retries; at the deadline
    :class:`BackoffDeadlineError` names the operation and the last error.
    Other exceptions propagate at once."""
    deadline = time.monotonic() + max(0.0, float(timeout))
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            now = time.monotonic()
            if now >= deadline:
                raise BackoffDeadlineError(what, timeout, attempt, e) from e
            time.sleep(max(0.0, min(cap, base * 2 ** (attempt - 1),
                                    deadline - now)))
