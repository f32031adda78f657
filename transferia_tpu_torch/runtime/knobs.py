"""Environment knobs (`TRANSFERIA_TPU_*`), read at call time.

The port reads the same knob names as the JAX package
(transferia_tpu/runtime/knobs.py) so one transfer configuration drives
both.  Helpers read the environment when called, not when imported, so
tests can monkeypatch `os.environ`.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

__all__ = ["env_bool", "env_float", "env_int", "env_raw", "env_str"]

# strings that read as False for env_bool; any other non-empty is True
_FALSY = frozenset({"0", "false", "no", "off"})


def _lookup(name: str, environ: Optional[Mapping[str, str]]):
    env = os.environ if environ is None else environ
    return env.get(name)


def env_raw(name: str,
            environ: Optional[Mapping[str, str]] = None) -> Optional[str]:
    """The raw value, or None when unset — for knobs whose *presence*
    is the signal (auto-vs-pinned tri-states like CHUNK_ROWS/LINK)."""
    return _lookup(name, environ)


def env_str(name: str, default: str = "",
            environ: Optional[Mapping[str, str]] = None) -> str:
    v = _lookup(name, environ)
    return default if v is None else v


def env_int(name: str, default: int,
            environ: Optional[Mapping[str, str]] = None) -> int:
    v = _lookup(name, environ)
    if v is None or not str(v).strip():
        return default
    try:
        return int(str(v).strip())
    except ValueError:
        return default


def env_float(name: str, default: float,
              environ: Optional[Mapping[str, str]] = None) -> float:
    v = _lookup(name, environ)
    if v is None or not str(v).strip():
        return default
    try:
        return float(str(v).strip())
    except ValueError:
        return default


def env_bool(name: str, default: bool,
             environ: Optional[Mapping[str, str]] = None) -> bool:
    """Kill-switch semantics: "0"/"false"/"no"/"off" (any case) are
    False, any other non-empty string is True, unset/empty keeps the
    default."""
    v = _lookup(name, environ)
    if v is None or not str(v).strip():
        return default
    return str(v).strip().lower() not in _FALSY
