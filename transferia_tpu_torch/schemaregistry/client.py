"""Schema Registry REST client over stdlib HTTP (the port's copy of
``transferia_tpu/schemaregistry/client.py``)."""

from __future__ import annotations

import json
import logging
from typing import Optional

from transferia_tpu_torch.abstract.errors import CategorizedError

logger = logging.getLogger(__name__)


class SRError(CategorizedError):
    pass


class SchemaRegistryClient:
    def __init__(self, url: str, user: str = "", password: str = "",
                 timeout: float = 30.0):
        import urllib.parse

        parsed = urllib.parse.urlparse(url)
        self.secure = parsed.scheme == "https"
        self.host = parsed.hostname or "localhost"
        self.port = parsed.port or (443 if self.secure else 8081)
        self.base = parsed.path.rstrip("/")
        self.user = user
        self.password = password
        self.timeout = timeout
        self._cache: dict[int, dict] = {}

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> dict:
        import http.client

        cls = http.client.HTTPSConnection if self.secure \
            else http.client.HTTPConnection
        conn = cls(self.host, self.port, timeout=self.timeout)
        try:
            headers = {
                "Content-Type": "application/vnd.schemaregistry.v1+json",
            }
            if self.user:
                import base64

                cred = base64.b64encode(
                    f"{self.user}:{self.password}".encode()
                ).decode()
                headers["Authorization"] = f"Basic {cred}"
            payload = json.dumps(body).encode() if body is not None \
                else None
            conn.request(method, self.base + path, body=payload,
                         headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise SRError(
                    CategorizedError.SOURCE,
                    f"schema registry HTTP {resp.status}: {data[:200]!r}",
                )
            return json.loads(data)
        except (ConnectionError, OSError) as e:
            raise SRError(CategorizedError.SOURCE,
                          f"schema registry unreachable: {e}") from e
        finally:
            conn.close()

    def _get(self, path: str) -> dict:
        return self._request("GET", path)

    def register_schema(self, subject: str, schema: str,
                        schema_type: str = "JSON") -> int:
        """POST /subjects/<subject>/versions -> schema id (idempotent on
        the registry side for identical schemas)."""
        out = self._request(
            "POST", f"/subjects/{subject}/versions",
            {"schema": schema, "schemaType": schema_type},
        )
        return int(out["id"])

    def schema_by_id(self, schema_id: int) -> dict:
        """Raw registry entry: {"schema": "...", "schemaType": "JSON"|...}"""
        if schema_id not in self._cache:
            self._cache[schema_id] = self._get(f"/schemas/ids/{schema_id}")
        return self._cache[schema_id]

    def fields_for(self, schema_id: int) -> Optional[list[dict]]:
        """Generic-parser field specs from a JSON-schema entry; None for
        schema types we can't map (avro/protobuf) — the parser then falls
        back to inference or _unparsed routing."""
        entry = self.schema_by_id(schema_id)
        if entry.get("schemaType", "AVRO") not in ("JSON",):
            logger.warning(
                "schema id %d is %s; JSON-schema only — falling back to "
                "inference", schema_id, entry.get("schemaType"),
            )
            return None
        try:
            schema = json.loads(entry["schema"])
        except (KeyError, ValueError):
            return None
        props = schema.get("properties")
        if not isinstance(props, dict):
            return None
        required = set(schema.get("required") or [])
        type_map = {
            "integer": "int64", "number": "double", "string": "utf8",
            "boolean": "boolean",
        }
        return [
            {
                "name": name,
                "type": type_map.get(
                    spec.get("type") if isinstance(spec, dict) else "",
                    "any",
                ),
                "required": name in required,
            }
            for name, spec in props.items()
        ]


def sr_resolver(url: str, **kw):
    """Resolver factory for the confluent_schema_registry parser config.
    The underlying client is exposed as `.client` so the parser's Avro
    path reuses the same connection/config and per-id cache."""
    client = SchemaRegistryClient(url, **kw)

    def resolve(schema_id: int):
        return client.fields_for(schema_id)

    resolve.client = client
    return resolve
