"""YTsaurus provider (the port's copy of ``transferia_tpu/providers/yt/``):
the HTTP-proxy client, the static-table source with row-range shards,
the static-table sink and the dynamic-table sink (`yt_dyn`).
"""

from transferia_tpu_torch.providers.yt.client import YTClient, YTError
from transferia_tpu_torch.providers.yt.provider import (
    YTProvider,
    YTSourceParams,
    YTStaticSinker,
    YTStaticTargetParams,
    YTStorage,
)

__all__ = [
    "YTClient",
    "YTError",
    "YTProvider",
    "YTSourceParams",
    "YTStaticSinker",
    "YTStaticTargetParams",
    "YTStorage",
]
