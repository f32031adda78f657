"""The parse -> push -> ack pipeline of the queue sources."""

from transferia_tpu_torch.parsequeue.queue import ParseQueue

__all__ = ["ParseQueue"]
