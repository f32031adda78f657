"""Built-in transformers of the port (self-registering)."""

from transferia_tpu_torch.transform.plugins import (  # noqa: F401
    convert,
    dbt,
    filter,
    lambda_tf,
    logger_tf,
    mask,
    misc,
    pk,
    rename,
)
