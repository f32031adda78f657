"""Two faults of the port's ClickHouse sink, pinned against the JAX
package on the CPU (each package against its own fake ClickHouse):

- C1: a batch filtered down to 0 rows makes no DDL and no INSERT, as the
  JAX sink's per-shard loop over no rows makes none (the fake holds no
  table), with and without a mask chain;
- C2: `CHTargetParams(is_shardeable=False)` is accepted and a 5,000-row
  `sample` snapshot lands every row, with staged commits off.

Exact: the fake's tables (DDL and rows) equal the JAX package's.
"""

import json

import numpy as np
import pytest

from tests.recipes.fake_clickhouse import FakeCH as RefFakeCH
from transferia_tpu import parsers as ref_parsers
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.factories import make_sinker as ref_make_sinker
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.providers.clickhouse import CHTargetParams as RefCH
from transferia_tpu.providers.sample import SampleSourceParams as RefSample
from transferia_tpu.tasks import SnapshotLoader as RefLoader
from transferia_tpu_torch import parsers
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.factories import make_sinker
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.providers.clickhouse import CHTargetParams
from transferia_tpu_torch.providers.sample import SampleSourceParams
from transferia_tpu_torch.recipes.fake_clickhouse import FakeCH
from transferia_tpu_torch.tasks import SnapshotLoader

JSON = {"json": {"table": "hits", "schema": [
    {"name": "id", "type": "int64", "key": True},
    {"name": "url", "type": "utf8"},
    {"name": "region", "type": "int32"}]}}
MASK = {"transformers": [{"mask_field": {"columns": ["url"],
                                         "salt": "s"}}]}

PKGS = {
    "port": (FakeCH, parsers, make_sinker, Transfer, SampleSourceParams,
             CHTargetParams, MemoryCoordinator, SnapshotLoader,
             {"device": "cpu"}),
    "jax": (RefFakeCH, ref_parsers, ref_make_sinker, RefTransfer,
            RefSample, RefCH, RefCoordinator, RefLoader, {}),
}


def ch_state(ch) -> dict:
    return {name: (tb["ddl"], sorted(tuple(sorted(r.items()))
                                     for r in tb["rows"]))
            for name, tb in ch.tables.items()}


def push_empty(pkg: str, transformation) -> dict:
    """A json batch filtered to 0 rows, pushed through make_sinker."""
    (fake, prs, mk_sinker, transfer, sample, ch_params, _, _,
     kw) = PKGS[pkg]
    ch = fake().start()
    try:
        msgs = [prs.Message(value=json.dumps(
            {"id": i, "url": f"u{i}", "region": i}).encode(), offset=i)
            for i in range(8)]
        (batch,) = prs.make_parser(JSON).do_batch(msgs).batches
        empty = batch.filter(np.zeros(batch.n_rows, dtype=bool))
        assert empty.n_rows == 0
        t = transfer(id=f"c1-{pkg}", src=sample(rows=0),
                     dst=ch_params(host="127.0.0.1", port=ch.port,
                                   bufferer=None),
                     transformation=transformation)
        sink = mk_sinker(t, snapshot_stage=False, **kw)
        try:
            sink.push(empty)
        finally:
            sink.close()
        return ch_state(ch)
    finally:
        ch.stop()


@pytest.mark.parametrize("transformation", [None, MASK],
                         ids=["no_chain", "mask_chain"])
def test_empty_batch_makes_no_table(transformation):
    got = push_empty("port", transformation)
    assert got == push_empty("jax", transformation)
    assert got == {}


def sample_to_ch(pkg: str) -> dict:
    """A 5,000-row sample snapshot into a non-shardable CH target."""
    (fake, _, _, transfer, sample, ch_params, coordinator, loader,
     kw) = PKGS[pkg]
    ch = fake().start()
    try:
        t = transfer(id=f"c2-{pkg}", src=sample(preset="users",
                                                 table="users", rows=5000),
                     dst=ch_params(host="127.0.0.1", port=ch.port,
                                   bufferer=None, is_shardeable=False))
        loader(t, coordinator(), **kw).upload_tables()
        return ch_state(ch)
    finally:
        ch.stop()


def test_not_shardeable_target_lands_every_row(monkeypatch):
    monkeypatch.setenv("TRANSFERIA_TPU_STAGED_COMMIT", "off")
    got = sample_to_ch("port")
    assert got == sample_to_ch("jax")
    ((_, rows),) = got.values()
    assert len(rows) == 5000
