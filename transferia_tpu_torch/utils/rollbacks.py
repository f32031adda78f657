"""Rollback stack (the port's copy of ``transferia_tpu/utils/rollbacks.py``).

Collects undo actions during a multi-step operation; `cancel()` on success
keeps the work, leaving the `with` block on failure runs the undos in
reverse order (best-effort, all attempted, first error re-raised).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class Rollbacks:
    def __init__(self):
        self._actions: list[tuple[str, Callable[[], None]]] = []
        self._cancelled = False

    def add(self, name: str, action: Callable[[], None]) -> None:
        self._actions.append((name, action))

    def cancel(self) -> None:
        """Operation succeeded: keep everything."""
        self._cancelled = True

    def run(self) -> None:
        if self._cancelled:
            return  # success already declared: undo nothing, ever
        first: Optional[BaseException] = None
        for name, action in reversed(self._actions):
            try:
                logger.info("rolling back: %s", name)
                action()
            except Exception as e:
                logger.error("rollback %s failed: %s", name, e)
                first = first or e
        self._actions.clear()
        if first is not None:
            raise first

    def __enter__(self) -> "Rollbacks":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None and not self._cancelled:
            try:
                self.run()
            except Exception:
                logger.exception("rollback errors (original error wins)")
        return False
