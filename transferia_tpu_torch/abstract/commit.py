"""Staged two-phase sink commit contract (the port's copy of
``transferia_tpu/abstract/commit.py``).

Sinks that can stage land a part's batches in a staging area keyed by
`(part, assignment_epoch)`; they become visible only after the
coordinator's fenced `commit_part` grants the publish:

    begin_part(key, epoch)      # open/replace the part's staging area
    push(...)*                  # batches stage (dedup window applied)
    -- coordinator.commit_part(operation, part) --   epoch-fenced
    publish_part(key, epoch)    # granted: staged data becomes visible
    abort_part(key)             # fenced/failed: staged data discarded

Begin replaces what was staged under the key, publish replaces what was
published under it, a publish older than the last accepted one raises
`StaleEpochPublishError`, and nothing staged is visible before publish.
Sinks without the capability keep the at-least-once path.
"""

from __future__ import annotations

import abc
from typing import Optional

from transferia_tpu_torch.abstract.interfaces import Sinker


class StagedSinker(abc.ABC):
    """Capability mixin for sinks that support the staged two-phase
    commit."""

    supports_staged_commit = True

    # rows the dedup window dropped during the most recent publish_part
    last_dedup_dropped: int = 0

    def staged_commit_available(self) -> bool:
        """True when this instance/configuration can stage."""
        return True

    @abc.abstractmethod
    def begin_part(self, key: str, epoch: int) -> None:
        """Open the staging area for a part under an assignment epoch,
        replacing anything previously staged for `key`."""

    @abc.abstractmethod
    def publish_part(self, key: str, epoch: int) -> int:
        """Make the staged data visible, replacing any previously
        published data for `key`.  Returns rows published."""

    @abc.abstractmethod
    def abort_part(self, key: str) -> None:
        """Discard the staging area for `key`.  Idempotent."""

    def note_push_retry(self) -> None:
        """Called by the sink Retrier right before it re-pushes a failed
        batch: arms the open stage's dedup window."""


# wrapper attributes the middleware/async layers use to hold the next
# sink down; walked in order by find_staged_sink
_INNER_ATTRS = ("inner", "_sinker", "sinker", "_inner")


def find_staged_sink(sink) -> Optional[StagedSinker]:
    """Walk a middleware/async sink chain down to the raw sink and return
    it when it is a StagedSinker whose configuration can stage, else
    None."""
    seen = set()
    cur = sink
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if isinstance(cur, StagedSinker):
            return cur if cur.staged_commit_available() else None
        nxt = None
        for attr in _INNER_ATTRS:
            cand = getattr(cur, attr, None)
            if cand is not None and (isinstance(cand, (Sinker, StagedSinker))
                                     or hasattr(cand, "async_push")):
                nxt = cand
                break
        cur = nxt
    return None
