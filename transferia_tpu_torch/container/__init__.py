"""Container job launcher (the port's copy of
``transferia_tpu/container/``)."""

from transferia_tpu_torch.container.runner import (
    ContainerError,
    ContainerRunner,
    ContainerSpec,
)

__all__ = ["ContainerError", "ContainerRunner", "ContainerSpec"]
