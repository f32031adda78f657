"""Transformer registry (pkg/transformer/registry.go:16-34).

Config shape (one-of map, matching the reference's Transformers YAML):

    transformation:
      transformers:
        - mask_field:  {columns: [url], salt: "secret"}
        - filter_rows: {filter: "x > 5"}

Only the transformers of the ported slice are registered; any other type
raises, naming the types this package knows.
"""

from __future__ import annotations

from typing import Any, Callable

from transferia_tpu_torch.transform.base import Transformer

_REGISTRY: dict[str, Callable[[dict], Transformer]] = {}


def register_transformer(type_name: str):
    """Decorator: register a Transformer class or factory under
    type_name."""

    def deco(cls_or_factory):
        if isinstance(cls_or_factory, type):
            cls_or_factory.TYPE = type_name
            _REGISTRY[type_name] = lambda cfg: cls_or_factory(**(cfg or {}))
        else:
            _REGISTRY[type_name] = cls_or_factory
        return cls_or_factory

    return deco


def make_transformer(type_name: str, config: dict) -> Transformer:
    factory = _REGISTRY.get(type_name)
    if factory is None:
        raise KeyError(
            f"transformer {type_name!r} is unknown or not yet ported to "
            f"transferia_tpu_torch; ported: {sorted(_REGISTRY)}"
        )
    return factory(config)


def parse_transformers_config(cfg: Any) -> list[Transformer]:
    """Parse the one-of list form into Transformer instances."""
    if not cfg:
        return []
    out = []
    for entry in cfg:
        if not isinstance(entry, dict) or len(entry) != 1:
            raise ValueError(
                f"each transformer entry must be a single-key map, got {entry!r}"
            )
        (type_name, config), = entry.items()
        out.append(make_transformer(type_name, config or {}))
    return out
