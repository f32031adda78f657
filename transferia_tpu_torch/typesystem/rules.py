"""Per-provider type-mapping rules (the port's copy of
``transferia_tpu/typesystem/rules.py``).

Providers register, at import time:
  - source rules: provider-native type string -> CanonicalType
  - target rules: CanonicalType -> target DDL type string
"""

from __future__ import annotations

from transferia_tpu_torch.abstract.schema import CanonicalType

ANY_DEFAULT = "*"

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


def map_source_type(provider: str, native_type: str,
                    default: CanonicalType = CanonicalType.ANY
                    ) -> CanonicalType:
    """Provider-native type name -> canonical type: exact, then the
    parametric base ("varchar(20)" -> "varchar"), then the provider's
    "*" rule."""
    rules = _SOURCE_RULES.get(provider, {})
    if native_type in rules:
        return rules[native_type]
    base = native_type.split("(", 1)[0].strip().lower()
    if base in rules:
        return rules[base]
    if ANY_DEFAULT in rules:
        return rules[ANY_DEFAULT]
    return default


def map_target_type(provider: str, ctype: CanonicalType,
                    default: str = "") -> str:
    """Canonical type -> target DDL type string."""
    return _TARGET_RULES.get(provider, {}).get(ctype, default or ctype.value)
