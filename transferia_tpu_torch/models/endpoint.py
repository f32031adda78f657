"""Endpoint parameter model + serialization registry (the port's copy of
``transferia_tpu/models/endpoint.py``).

Capabilities are opt-in methods/attributes on params classes;
`capability` reads them with safe defaults, so providers only declare
what they support.  `to_dict`/`endpoint_from_dict` round-trip params
through JSON or YAML (the CLI's transfer.yaml).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Any, Optional, Type


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

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        for k, v in list(d.items()):
            if isinstance(v, enum.Enum):
                d[k] = v.value
        d["__provider__"] = self.provider()
        d["__role__"] = "source" if type(self).IS_SOURCE else "target"
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "EndpointParams":
        """Known fields only (`__`-keys and unknown keys are dropped);
        nested values stay as given, as in the reference."""
        kwargs = {}
        names = {f.name for f in dataclasses.fields(cls)}
        for k, v in d.items():
            if k.startswith("__") or k not in names:
                continue
            if k == "cleanup_policy":
                v = CleanupPolicy(v)
            kwargs[k] = v
        return cls(**kwargs)


# (provider, role) -> params class
_ENDPOINT_REGISTRY: dict[tuple[str, str], Type[EndpointParams]] = {}


def register_endpoint(cls: Type[EndpointParams]) -> Type[EndpointParams]:
    """Class decorator: register a params class for the YAML/JSON round
    trip, under its provider and role."""
    role = "source" if cls.IS_SOURCE else "target"
    _ENDPOINT_REGISTRY[(cls.PROVIDER, role)] = cls
    return cls


def endpoint_from_dict(d: dict[str, Any],
                       provider: Optional[str] = None,
                       role: Optional[str] = None) -> EndpointParams:
    provider = provider or d.get("__provider__", "")
    role = role or d.get("__role__", "source")
    cls = _ENDPOINT_REGISTRY.get((provider, role))
    if cls is None:
        raise KeyError(
            f"unknown endpoint: provider={provider!r} role={role!r}; "
            f"known: {sorted(_ENDPOINT_REGISTRY)}"
        )
    return cls.from_dict(d)


def capability(params: Any, name: str, default: Any = None) -> Any:
    """Read an opt-in capability attribute/method with a default,
    e.g. capability(dst, "bufferer_config", None)."""
    v = getattr(params, name, default)
    return v() if callable(v) else v
