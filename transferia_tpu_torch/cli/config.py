"""transfer.yaml parsing (the port's copy of
``transferia_tpu/cli/config.py``).

Shape:

    id: my-transfer
    type: SNAPSHOT_ONLY            # | INCREMENT_ONLY | SNAPSHOT_AND_INCREMENT
    src:
      type: sample                 # provider name
      params: { ... }              # provider endpoint params
    dst:
      type: stdout
      params: { ... }
    transformation:
      transformers:
        - mask_field: {columns: [email], salt: "${MASK_SALT}"}
    data_objects: ["ns.table", ...]
    regular_snapshot: {enabled: true, cron: "0 3 * * *", incremental: [...]}
    runtime: {job_count: 1, process_count: 4}
    type_system_version: 1

Environment substitution `${VAR}` / `${VAR:default}` in every string
scalar; unknown top-level keys are refused.  The YAML is read by the
port's own reader (`yamlread.py`: the reference's `yaml.safe_load` on the
subset a transfer.yaml uses).  A provider the reference has and the port
has not yet is refused naming its ROADMAP.md item.
"""

from __future__ import annotations

import os
import re
from typing import Any

from transferia_tpu_torch.cli.yamlread import ConfigError, load
from transferia_tpu_torch.models import Transfer, TransferType
from transferia_tpu_torch.models.endpoint import endpoint_from_dict
from transferia_tpu_torch.models.transfer import (
    DataObjects,
    IncrementalTableCfg,
    RegularSnapshot,
    Runtime,
    ShardingUploadParams,
)
from transferia_tpu_torch.typesystem.fallbacks import LATEST_VERSION

__all__ = ["ConfigError", "load_transfer", "parse_transfer_yaml"]

_ENV_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)(?::([^}]*))?\}")

_KNOWN_KEYS = {
    "id", "type", "src", "dst", "transformation", "data_objects",
    "regular_snapshot", "runtime", "type_system_version", "labels",
    "validation",
}

# the reference's endpoints the port has no params class for yet: all
# wait under ROADMAP.md A7 ("every other provider"; the `fs` sink with it)
WAITING_PROVIDERS = frozenset({
    "arrow_ipc", "elastic", "eventhub", "flight", "greenplum", "kinesis",
    "logbroker", "opensearch", "ydb", "yds",
})


def _substitute_env(value: Any) -> Any:
    if isinstance(value, str):
        def repl(m):
            var, default = m.group(1), m.group(2)
            v = os.environ.get(var)
            if v is None:
                if default is not None:
                    return default
                raise ConfigError(f"environment variable {var} is not set")
            return v

        return _ENV_RE.sub(repl, value)
    if isinstance(value, dict):
        return {k: _substitute_env(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_substitute_env(v) for v in value]
    return value


def parse_transfer_yaml(text: str) -> Transfer:
    raw = load(text)
    if not isinstance(raw, dict):
        raise ConfigError("transfer config must be a YAML mapping")
    raw = _substitute_env(raw)
    unknown = set(raw) - _KNOWN_KEYS
    if unknown:
        raise ConfigError(
            f"unknown config keys: {sorted(unknown)}; "
            f"known: {sorted(_KNOWN_KEYS)}"
        )
    for side in ("src", "dst"):
        if side not in raw:
            raise ConfigError(f"missing required key {side!r}")
        ep = raw[side]
        if not isinstance(ep, dict) or "type" not in ep:
            raise ConfigError(f"{side} must be a mapping with a 'type' key")
    try:
        ttype = TransferType(raw.get("type", "SNAPSHOT_ONLY"))
    except ValueError as e:
        raise ConfigError(
            f"bad transfer type {raw.get('type')!r}; valid: "
            f"{[t.value for t in TransferType]}"
        ) from e

    def endpoint(side: str, role: str):
        ep = raw[side]
        params = dict(ep.get("params") or {})
        try:
            return endpoint_from_dict(params, provider=ep["type"], role=role)
        except KeyError as e:
            if ep["type"] == "bigquery":
                from transferia_tpu_torch.providers.misc_providers import (
                    BIGQUERY_BLOCKED,
                )

                raise ConfigError(f"provider 'bigquery' ({role}): "
                                  f"{BIGQUERY_BLOCKED}") from e
            if ep["type"] in WAITING_PROVIDERS:
                raise ConfigError(
                    f"provider {ep['type']!r} ({role}) is not ported to "
                    f"transferia_tpu_torch yet (ROADMAP.md A7, every "
                    f"other provider)") from e
            raise ConfigError(str(e)) from e

    # providers self-register endpoint classes on import
    from transferia_tpu_torch.providers import load_builtin_providers

    load_builtin_providers()

    rt = raw.get("runtime") or {}
    rs = raw.get("regular_snapshot") or {}
    return Transfer(
        id=str(raw.get("id", "transfer")),
        type=ttype,
        src=endpoint("src", "source"),
        dst=endpoint("dst", "target"),
        transformation=raw.get("transformation"),
        data_objects=DataObjects(list(raw.get("data_objects") or [])),
        regular_snapshot=RegularSnapshot(
            enabled=bool(rs.get("enabled", False)),
            cron=rs.get("cron", ""),
            incremental=[
                IncrementalTableCfg(**i) for i in rs.get("incremental", [])
            ],
        ),
        runtime=Runtime(
            current_job=int(rt.get("current_job", 0)),
            sharding=ShardingUploadParams(
                job_count=int(rt.get("job_count", 1)),
                process_count=int(rt.get("process_count", 4)),
            ),
            replication_workers=int(rt.get("replication_workers", 1)),
        ),
        type_system_version=int(
            raw.get("type_system_version", LATEST_VERSION)
        ),
        labels=dict(raw.get("labels") or {}),
        validation=raw.get("validation"),
    )


def load_transfer(path: str) -> Transfer:
    with open(path) as fh:
        return parse_transfer_yaml(fh.read())
