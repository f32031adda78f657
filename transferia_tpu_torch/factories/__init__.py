"""Factories of the port: the sink pipeline and the snapshot storage."""

from transferia_tpu_torch.factories.sink import make_async_sink, make_sinker
from transferia_tpu_torch.factories.storage import new_storage

__all__ = ["make_async_sink", "make_sinker", "new_storage"]
