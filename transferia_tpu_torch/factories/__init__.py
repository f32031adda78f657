"""Factories of the port: the sink pipeline, the snapshot storage and the
replication source."""

from transferia_tpu_torch.factories.sink import make_async_sink, make_sinker
from transferia_tpu_torch.factories.source import new_source
from transferia_tpu_torch.factories.storage import new_storage

__all__ = ["make_async_sink", "make_sinker", "new_source", "new_storage"]
