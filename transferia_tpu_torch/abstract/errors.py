"""Error taxonomy (the port's copy of ``transferia_tpu/abstract/errors.py``).

Fatal errors stop a transfer instead of being retried; coded errors
carry a stable machine-readable code; `is_retriable` is the single retry
predicate the snapshot engine and the sink Retrier share.
"""

from __future__ import annotations

from typing import Optional


class TransferError(Exception):
    """Base class for framework errors."""


class FatalError(TransferError):
    """Non-retriable: the transfer must be failed."""


class AbortTransferError(FatalError):
    """Operator-visible abort (bad config, incompatible schema)."""


class WorkerKilledError(TransferError):
    """The worker is dying.  Not retriable: the part must stay mid-flight
    with its lease intact so a surviving worker reclaims it."""


class StaleEpochPublishError(TransferError):
    """A staged-commit publish carried an assignment epoch older than the
    sink's last accepted publish for the part (a zombie woke after its
    part was reclaimed and republished).  Not retriable."""

    def __init__(self, key: str, epoch: int, published_epoch: int):
        super().__init__(
            f"stale publish of {key!r}: epoch {epoch} <= already "
            f"published epoch {published_epoch}")
        self.key = key
        self.epoch = epoch
        self.published_epoch = published_epoch


class CodedError(TransferError):
    """Error with a stable code."""

    def __init__(self, code: str, message: str, fatal: bool = False):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.fatal = fatal


class Codes:
    GENERIC_NO_PKEY = "generic.no_primary_key"
    MAIN_WORKER_RESTART = "runtime.main_worker_restart"
    UNPARSEABLE = "parser.unparseable"
    MISSING_DATA_TRANSFORMATION = "transformer.missing_data"
    DIAL_TIMEOUT = "network.dial_timeout"
    DROP_NOT_ALLOWED = "target.drop_not_allowed"
    TABLE_SPLIT_FAILED = "storage.table_split_failed"
    SNAPSHOT_PARTS_ORPHANED = "snapshot.parts_orphaned"


class CategorizedError(TransferError):
    """Error attributed to the source or the target."""

    SOURCE = "source"
    TARGET = "target"

    def __init__(self, category: str, message: str):
        super().__init__(f"({category}) {message}")
        self.category = category


class TableUploadError(TransferError):
    """Per-part upload failure; retried with backoff by the snapshot
    loader."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause


def cause_chain(err: BaseException):
    """Iterate an error and its causes (``__cause__`` or a ``cause``
    attribute, cycle-safe)."""
    seen = set()
    cur: Optional[BaseException] = err
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        yield cur
        cur = cur.__cause__ or getattr(cur, "cause", None)


def is_fatal(err: BaseException) -> bool:
    return any(isinstance(cur, FatalError)
               or (isinstance(cur, CodedError) and cur.fatal)
               for cur in cause_chain(err))


def is_worker_kill(err: BaseException) -> bool:
    """True when a WorkerKilledError sits anywhere in the cause chain
    (the snapshot loader wraps part failures in TableUploadError)."""
    return any(isinstance(cur, WorkerKilledError)
               for cur in cause_chain(err))


# Programming/schema errors: a retry re-runs the same code on the same
# input, so they fail fast, walked through the cause chain like is_fatal.
_NON_RETRIABLE_TYPES = (TypeError, AttributeError, NameError, KeyError,
                        IndexError, AssertionError, WorkerKilledError,
                        StaleEpochPublishError)


def is_retriable(err: BaseException) -> bool:
    """Fatal errors and programming/schema errors anywhere in the cause
    chain fail fast; everything else gets the backoff schedule."""
    if is_fatal(err):
        return False
    return not any(isinstance(cur, _NON_RETRIABLE_TYPES)
                   for cur in cause_chain(err))
