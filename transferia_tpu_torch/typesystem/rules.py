"""Per-provider type-mapping rules (the port's copy of
``transferia_tpu/typesystem/rules.py``).

Providers register, at import time:
  - source rules: provider-native type string -> CanonicalType
  - target rules: CanonicalType -> target DDL type string
"""

from __future__ import annotations

from transferia_tpu_torch.abstract.schema import CanonicalType

_SOURCE_RULES: dict[str, dict[str, CanonicalType]] = {}
_TARGET_RULES: dict[str, dict[CanonicalType, str]] = {}


def register_source_rules(provider: str,
                          rules: dict[str, CanonicalType]) -> None:
    _SOURCE_RULES.setdefault(provider, {}).update(rules)


def register_target_rules(provider: str,
                          rules: dict[CanonicalType, str]) -> None:
    _TARGET_RULES.setdefault(provider, {}).update(rules)


def source_rules(provider: str) -> dict[str, CanonicalType]:
    return dict(_SOURCE_RULES.get(provider, {}))


def map_target_type(provider: str, ctype: CanonicalType,
                    default: str = "") -> str:
    """Canonical type -> target DDL type string."""
    return _TARGET_RULES.get(provider, {}).get(ctype, default or ctype.value)
