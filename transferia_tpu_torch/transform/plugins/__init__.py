"""Built-in transformers of the ported slice (self-registering)."""

from transferia_tpu_torch.transform.plugins import (  # noqa: F401
    filter,
    lambda_tf,
    mask,
    rename,
)
