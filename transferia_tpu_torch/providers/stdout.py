"""stdout debug sink and the counting null sink (the port's copy of
``transferia_tpu/providers/stdout.py``; reference: pkg/providers/stdout/)."""

from __future__ import annotations

import sys
from dataclasses import dataclass

from transferia_tpu_torch.abstract.interfaces import (
    Batch,
    Sinker,
    is_columnar,
)
from transferia_tpu_torch.middlewares.helpers import batch_len
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.providers.registry import (
    Provider,
    register_provider,
)


@register_endpoint
@dataclass
class StdoutTargetParams(EndpointParams):
    PROVIDER = "stdout"
    IS_TARGET = True

    verbose: bool = False      # print full rows, not just summaries
    max_rows_printed: int = 20


class StdoutSinker(Sinker):
    def __init__(self, params: StdoutTargetParams):
        self.params = params
        self.total_rows = 0

    def push(self, batch: Batch) -> None:
        n = batch_len(batch)
        self.total_rows += n
        if is_columnar(batch):
            print(f"[stdout sink] {batch.table_id}: columnar batch "
                  f"{n} rows x {len(batch.columns)} cols "
                  f"({batch.nbytes()} bytes)")
            if self.params.verbose:
                for row in batch.slice(
                        0, self.params.max_rows_printed).to_rows():
                    print(f"  {row.kind.value} {row.as_dict()}")
        else:
            for it in batch[:self.params.max_rows_printed]:
                if it.is_row_event() and not self.params.verbose:
                    continue
                print(f"[stdout sink] {it.kind.value} {it.table_id} "
                      f"{it.as_dict() if it.is_row_event() else ''}")
        sys.stdout.flush()


@register_provider
class StdoutProvider(Provider):
    NAME = "stdout"

    def sinker(self):
        return StdoutSinker(self.transfer.dst)


@register_endpoint
@dataclass
class NullTargetParams(EndpointParams):
    """Counting /dev/null sink (benchmarks; reference ErrorsOutput
    devnull)."""

    PROVIDER = "devnull"
    IS_TARGET = True


class NullSinker(Sinker):
    def __init__(self):
        self.total_rows = 0
        self.total_bytes = 0

    def push(self, batch: Batch) -> None:
        self.total_rows += batch_len(batch)
        if is_columnar(batch):
            self.total_bytes += batch.nbytes()


@register_provider
class NullProvider(Provider):
    NAME = "devnull"

    def sinker(self):
        return NullSinker()
