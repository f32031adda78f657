"""Confluent Schema Registry client (the port's copy of
``transferia_tpu/schemaregistry/``).

Resolves schema ids from the registry's REST API, adapts JSON-schema
definitions into the generic parser's field specs and decodes Avro
payloads by their writer schema; plugs into the
confluent_schema_registry parser as its resolver.
"""

from transferia_tpu_torch.schemaregistry.client import (
    SchemaRegistryClient,
    sr_resolver,
)

__all__ = ["SchemaRegistryClient", "sr_resolver"]
