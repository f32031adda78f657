"""A fake Airbyte source connector: a stdlib script that speaks the
Airbyte protocol on stdout (spec, check, discover, read), for the
container runner's `exec` runtime, after the connector of
``tests/e2e/test_container_e2e.py``.

    python3 airbyte_connector.py check    --config config.json
    python3 airbyte_connector.py discover --config config.json
    python3 airbyte_connector.py read     --config config.json \\
        --catalog catalog.json [--state state.json]

The config names the streams: ``{"api_key": "k", "streams": [{"name":
..., "shape": "users" | "typed", "total": N | "per_read": N}]}``.  A
stream's records are a pure function of their id (`record`); `read`
emits the configured catalog's streams from the state's cursor (0
without a state) up to `total`, or `per_read` records past it, then one
STATE message with the new cursor (the protocol's legacy state blob, as
the JAX package's test connector writes it).  `check` succeeds when
`api_key` equals `expect_key` (default "k").  Without streams in the
config the connector has the JAX test connector's one `users` stream,
four records a read.
"""

from __future__ import annotations

import json
import sys

SHAPES = {
    # the JAX test connector's stream
    "users": {
        "id": {"type": "integer"},
        "email": {"type": ["null", "string"]},
        "meta": {"type": "object"},
    },
    # every scalar the protocol types: integer, number, string, boolean
    # and a date-time string
    "typed": {
        "id": {"type": "integer"},
        "amount": {"type": "number"},
        "email": {"type": "string"},
        "active": {"type": "boolean"},
        "region": {"type": "integer"},
        "created_at": {"type": "string", "format": "date-time"},
    },
}
DEFAULT_STREAMS = [{"name": "users", "shape": "users", "per_read": 4}]


def record(shape: str, stream: str, i: int) -> dict:
    """The record with id `i` of a stream of `shape`."""
    if shape == "users":
        return {"id": i, "email": f"u{i}@x.io", "meta": {"n": i}}
    return {
        "id": i,
        "amount": (i * 7919 % 1_000_000) / 100.0,
        "email": f"{stream}{i}@example.test",
        "active": i % 3 != 0,
        "region": i * 37 % 500,
        "created_at": "2024-%02d-%02dT%02d:%02d:%02dZ" % (
            i % 12 + 1, i % 28 + 1, i % 24, i % 60, i * 7 % 60),
    }


def catalog(config: dict) -> dict:
    return {"streams": [{
        "name": s["name"],
        "json_schema": {"properties": SHAPES[s.get("shape", "typed")]},
        "supported_sync_modes": ["full_refresh", "incremental"],
        "source_defined_cursor": True,
        "default_cursor_field": ["id"],
        "source_defined_primary_key": [["id"]],
    } for s in config.get("streams") or DEFAULT_STREAMS]}


def _arg(argv: list, name: str):
    return argv[argv.index(name) + 1] if name in argv else None


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def main(argv: list) -> int:
    out = sys.stdout
    mode = argv[0]
    if mode == "spec":
        out.write(json.dumps({"type": "SPEC", "spec": {
            "connectionSpecification": {"properties": {
                "api_key": {"type": "string"},
                "streams": {"type": "array"}}}}}) + "\n")
        return 0
    config = _load(_arg(argv, "--config"))
    if mode == "check":
        ok = config.get("api_key") == config.get("expect_key", "k")
        out.write(json.dumps({"type": "CONNECTION_STATUS",
                              "connectionStatus": {
                                  "status": "SUCCEEDED" if ok else "FAILED",
                                  "message": "bad api_key"}}) + "\n")
        return 0
    if mode == "discover":
        out.write(json.dumps({"type": "CATALOG",
                              "catalog": catalog(config)}) + "\n")
        return 0
    if mode != "read":
        sys.stderr.write(f"unknown mode {mode!r}\n")
        return 2
    specs = {s["name"]: s for s in config.get("streams") or DEFAULT_STREAMS}
    configured = _load(_arg(argv, "--catalog"))
    state_path = _arg(argv, "--state")
    start = _load(state_path).get("cursor", 0) if state_path else 0
    out.write(json.dumps({"type": "LOG", "log": {
        "level": "INFO", "message": f"reading from cursor {start}"}}) + "\n")
    for entry in configured["streams"]:
        name = entry["stream"]["name"]
        spec = specs[name]
        shape = spec.get("shape", "typed")
        # counts may come as strings (a transfer.yaml's substitutions)
        end = int(spec["total"]) if "total" in spec \
            else start + int(spec["per_read"])
        lines = []
        for i in range(start, end):
            lines.append(json.dumps({"type": "RECORD", "record": {
                "stream": name, "emitted_at": 1,
                "data": record(shape, name, i)}}))
            if len(lines) == 4096:
                out.write("\n".join(lines) + "\n")
                lines = []
        if lines:
            out.write("\n".join(lines) + "\n")
        out.write(json.dumps({"type": "STATE",
                              "state": {"cursor": max(end, start)}}) + "\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
