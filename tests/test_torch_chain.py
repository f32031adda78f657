"""The slice as a whole: the port's chain against the JAX package's chain.

`build_chain(cfg, device="cpu").apply(batch)` of the port (the fused
step running every kernel's plain PyTorch version) must give, column for
column, the same bytes as `transferia_tpu.transform.build_chain(cfg)
.apply(batch)` on the same ragged 1024*k+17-row batch, for the ClickBench
config (bench.py make_transfer) and the production-chain config of
__graft_entry__.dryrun_multichip, in both dispatch encodings, with
chunked dispatch forced on and off.  Both plan the same fused step.
"""

import numpy as np
import pytest

from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.ops import dispatch as ref_dispatch
from transferia_tpu.ops import fused as ref_fused
from transferia_tpu.transform import build_chain as ref_build_chain
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.ops import dispatch as port_dispatch
from transferia_tpu_torch.ops import fused as port_fused
from transferia_tpu_torch.transform import build_chain
from transferia_tpu_torch.transform import fused as port_tfused

ROWS = 1024 * 2 + 17  # ragged on purpose: bucket padding must wash out

CLICKBENCH = {"transformers": [
    {"mask_field": {"columns": ["URL"], "salt": "bench-salt"}},
    {"filter_rows": {"filter": "RegionID < 400 AND ResolutionWidth >= 390"}},
]}
DRYRUN = {"transformers": [
    {"mask_field": {"columns": ["url"], "salt": "dryrun"}},
    {"filter_rows": {"filter": "region < 400"}},
]}


def clickbench_data(n):
    """bench.py generate_dataset's columns (a few), seed 42."""
    rng = np.random.default_rng(42)
    region = rng.integers(0, 500, n).astype(np.int32)
    res_w = rng.choice(np.array([1280, 1366, 1536, 1920, 2560, 360, 390],
                                dtype=np.int32), n)
    host_ids = rng.integers(0, 997, n)
    path_ids = rng.integers(0, 10_000_019, n)
    cols = [("WatchID", "int64"), ("RegionID", "int32"),
            ("ResolutionWidth", "int32"), ("URL", "utf8"),
            ("Title", "utf8")]
    data = {
        "WatchID": rng.integers(0, 2**62, n).tolist(),
        "RegionID": region.tolist(),
        "ResolutionWidth": res_w.tolist(),
        "URL": [f"https://example-{h}.com/page/{p}"
                for h, p in zip(host_ids, path_ids)],
        "Title": [f"Title {t}" for t in rng.integers(0, 99_991, n)],
    }
    return cols, data


def dryrun_data(n):
    """__graft_entry__.dryrun_multichip's production-chain batch."""
    rng = np.random.default_rng(1)
    cols = [("id", "int64", True), ("url", "utf8"), ("region", "int32")]
    data = {
        "id": list(range(n)),
        "url": [f"https://h/{i}" for i in range(n)],
        "region": [int(x) for x in rng.integers(0, 500, n)],
    }
    return cols, data


CASES = {"clickbench": (CLICKBENCH, clickbench_data),
         "dryrun": (DRYRUN, dryrun_data)}


@pytest.fixture
def knobs():
    """Pin both packages' knobs; restore them afterwards."""
    def pin(encoding, chunk):
        for mod in (ref_dispatch, port_dispatch):
            mod.set_dispatch_encoding(encoding)
        for mod in (ref_fused, port_fused):
            mod.set_chunk_rows(chunk)
        for mod in (ref_tfused, port_tfused):
            mod.set_placement("device")
        ref_tfused.set_device_fusion(True)

    yield pin
    for mod in (ref_dispatch, port_dispatch):
        mod.set_dispatch_encoding(None)
    for mod in (ref_fused, port_fused):
        mod.set_chunk_rows(None)
    for mod in (ref_tfused, port_tfused):
        mod.set_placement(None)
    ref_tfused.set_device_fusion(None)


def column_bytes(col):
    return (col.ctype.value, np.asarray(col.data).tobytes(),
            None if col.offsets is None else col.offsets.tobytes(),
            None if col.validity is None else col.validity.tobytes())


def check_chain(config, cols, data, pin, encoding, chunk):
    """Run both packages' chains on one batch; assert byte identity."""
    port_batch = ColumnBatch.from_pydict(TableID("bench", "hits"),
                                         new_table_schema(cols), data)
    ref_batch = RefBatch.from_pydict(port_batch.table_id, ref_schema(cols),
                                     data)
    pin(encoding, chunk)
    chain = build_chain(config, device="cpu")
    ref_chain = ref_build_chain(config)
    step = chain.plan_for(port_batch.table_id, port_batch.schema).steps
    ref_step = ref_chain.plan_for(ref_batch.table_id, ref_batch.schema).steps
    assert len(step) == 1 and isinstance(step[0],
                                         port_tfused.DeviceFusedStep)
    assert isinstance(ref_step[0], ref_tfused.DeviceFusedStep)
    assert step[0].describe() == ref_step[0].describe()

    out = chain.apply(port_batch)
    ref_out = ref_chain.apply(ref_batch)
    assert 0 < out.n_rows < ROWS
    assert out.schema.names() == ref_out.schema.names()
    for name in out.schema.names():
        assert column_bytes(out.column(name)) == \
            column_bytes(ref_out.column(name)), name


@pytest.mark.parametrize("chunk", [256, 0])
@pytest.mark.parametrize("encoding", ["raw", "auto"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_byte_identical_to_jax(case, encoding, chunk, knobs):
    config, make = CASES[case]
    cols, data = make(ROWS)
    check_chain(config, cols, data, knobs, encoding, chunk)
