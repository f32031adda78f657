"""Endpoint parameter model + registry (the port's copy of
``transferia_tpu/models/endpoint.py``).

Capabilities are opt-in methods/attributes on params classes;
`capability` reads them with safe defaults, so providers only declare
what they support.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Type


class CleanupPolicy(str, enum.Enum):
    """Destination cleanup on (re)activation."""

    DROP = "drop"
    TRUNCATE = "truncate"
    DISABLED = "disabled"


@dataclass
class EndpointParams:
    """Base endpoint parameters; providers subclass with their own fields.

    Class attributes:
      PROVIDER: registry key (e.g. "sample", "memory").
      IS_SOURCE/IS_TARGET: which roles the subclass may play.
    """

    PROVIDER = ""
    IS_SOURCE = False
    IS_TARGET = False

    cleanup_policy: CleanupPolicy = CleanupPolicy.DROP

    def provider(self) -> str:
        return type(self).PROVIDER


# (provider, role) -> params class
_ENDPOINT_REGISTRY: dict[tuple[str, str], Type[EndpointParams]] = {}


def register_endpoint(cls: Type[EndpointParams]) -> Type[EndpointParams]:
    """Class decorator: register a params class under its provider and
    role."""
    role = "source" if cls.IS_SOURCE else "target"
    _ENDPOINT_REGISTRY[(cls.PROVIDER, role)] = cls
    return cls


def capability(params: Any, name: str, default: Any = None) -> Any:
    """Read an opt-in capability attribute/method with a default,
    e.g. capability(dst, "bufferer_config", None)."""
    v = getattr(params, name, default)
    return v() if callable(v) else v
