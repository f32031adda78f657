"""Per-provider type-mapping rules (the port's copy of the source half of
``transferia_tpu/typesystem/rules.py``): providers register, at import
time, their native type names -> CanonicalType.  The target rules come
with the first provider that writes DDL."""

from __future__ import annotations

from transferia_tpu_torch.abstract.schema import CanonicalType

_SOURCE_RULES: dict[str, dict[str, CanonicalType]] = {}


def register_source_rules(provider: str,
                          rules: dict[str, CanonicalType]) -> None:
    _SOURCE_RULES.setdefault(provider, {}).update(rules)


def source_rules(provider: str) -> dict[str, CanonicalType]:
    return dict(_SOURCE_RULES.get(provider, {}))
