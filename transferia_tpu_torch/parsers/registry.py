"""Parser registry (the port's copy of
``transferia_tpu/parsers/registry.py``).

Config shape (the endpoint's `parser`):

    parser:
      json: {schema: [...], table: "t", add_system_cols: true}
    # or: tskv / generic / blank / raw_to_table
"""

from __future__ import annotations

from typing import Any, Callable

from transferia_tpu_torch.parsers.base import Parser

_REGISTRY: dict[str, Callable[[dict], Parser]] = {}


def register_parser(type_name: str):
    def deco(cls_or_factory):
        if isinstance(cls_or_factory, type):
            cls_or_factory.TYPE = type_name
            _REGISTRY[type_name] = lambda cfg: cls_or_factory(**(cfg or {}))
        else:
            _REGISTRY[type_name] = cls_or_factory
        return cls_or_factory

    return deco


def make_parser(config: Any) -> Parser:
    """Build from a {type_name: cfg} one-of map or (type_name, cfg)."""
    if isinstance(config, dict):
        if len(config) != 1:
            raise ValueError(
                f"parser config must be a single-key map, got {config!r}"
            )
        (type_name, cfg), = config.items()
    else:
        type_name, cfg = config
    factory = _REGISTRY.get(type_name)
    if factory is None:
        raise KeyError(
            f"unknown parser {type_name!r}; ported: {sorted(_REGISTRY)} "
            f"(the others wait: ROADMAP.md A10)"
        )
    p = factory(cfg or {})
    p.TYPE = type_name
    return p

