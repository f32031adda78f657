"""Built-in transformers of the ported slice (self-registering)."""

from transferia_tpu_torch.transform.plugins import filter, mask  # noqa: F401
