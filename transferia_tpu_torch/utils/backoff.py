"""Exponential backoff retry (the port's copy of
``transferia_tpu/utils/backoff.py``).

Full jitter by default: the i-th wait is uniform(0, min(max_delay,
base * 2^(i-1))), so N upload workers knocked over by one sink hiccup do
not all come back on the same tick.  The reference's stop event and
seeded jitter have no caller in the port.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, TypeVar

T = TypeVar("T")


def retry_with_backoff(
    fn: Callable[[], T],
    attempts: int = 3,
    base_delay: float = 0.5,
    max_delay: float = 30.0,
    retriable: Callable[[BaseException], bool] = lambda e: True,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    jitter: bool = True,
) -> T:
    """Run fn with up to `attempts` tries; exponential backoff between
    tries.  Re-raises the last error when attempts are exhausted or when
    `retriable` returns False."""
    cap = base_delay
    last: Optional[BaseException] = None
    for i in range(1, attempts + 1):
        try:
            return fn()
        # Exception only: KeyboardInterrupt/SystemExit abort at once
        except Exception as e:
            last = e
            if i >= attempts or not retriable(e):
                raise
            if on_retry:
                on_retry(i, e)
            delay = min(cap, max_delay)
            if jitter:
                delay = random.uniform(0.0, delay)
            time.sleep(delay)
            cap *= 2
    raise last  # pragma: no cover - unreachable
