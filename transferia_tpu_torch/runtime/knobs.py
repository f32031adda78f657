"""Environment knobs (`TRANSFERIA_TPU_*`), read at call time.

The port reads the same knob names as the JAX package
(transferia_tpu/runtime/knobs.py) so one transfer configuration drives
both.  Helpers read the environment when called, not when imported, so
tests can monkeypatch `os.environ`.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["env_float", "env_int", "env_raw", "env_str"]


def env_raw(name: str) -> Optional[str]:
    """The raw value, or None when unset — for knobs whose *presence*
    is the signal (auto-vs-pinned tri-states like CHUNK_ROWS/LINK)."""
    return os.environ.get(name)


def env_str(name: str, default: str = "") -> str:
    v = os.environ.get(name)
    return default if v is None else v


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or not str(v).strip():
        return default
    try:
        return int(str(v).strip())
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or not str(v).strip():
        return default
    try:
        return float(str(v).strip())
    except ValueError:
        return default
