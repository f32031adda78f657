"""The in-memory broker provider (the port's `providers/mq.py`) against
the JAX package's, on the CPU.

- `MemoryBroker`: produce (by key hash and by partition), fetch past
  superseded tombstones, consumer-group commits, the staged part
  publish, a republish that supersedes in place (offsets stay stable)
  and a stale epoch's refusal, each equal to the JAX broker's on the
  same seeded messages.
- `MQSinker`: a plain push and a staged part (begin, push, publish,
  republish, a stale publish) land the same messages in both brokers;
  the port's sink keys its staged batches with `device="cpu"`.
- `_MQClient`: fetch, commit and seek equal.
- An mq -> memory replication through the mask (the chaos runner's
  replication transfer, `run_replication` on the CPU) delivers the JAX
  package's rows.
"""

import json

import numpy as np
import pytest

from transferia_tpu.abstract.errors import (
    StaleEpochPublishError as RefStale,
)
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.chaos import runner as ref_runner
from transferia_tpu.coordinator.memory import (
    MemoryCoordinator as RefCoordinator,
)
from transferia_tpu.providers import mq as ref_mq
from transferia_tpu.providers.memory import get_store as ref_get_store
from transferia_tpu.providers.sample import make_batch as ref_make_batch
from transferia_tpu_torch.abstract.errors import StaleEpochPublishError
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.chaos import runner as port_runner
from transferia_tpu_torch.coordinator.memory import MemoryCoordinator
from transferia_tpu_torch.providers import mq as port_mq
from transferia_tpu_torch.providers.memory import get_store
from transferia_tpu_torch.providers.sample import make_batch

PKG = {"port": port_mq, "jax": ref_mq}
STALE = {"port": StaleEpochPublishError, "jax": RefStale}


def messages(seed: int, n: int) -> list:
    """(key, value, partition or None) triples from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = f"k{int(rng.integers(0, 50))}".encode()
        value = json.dumps({"id": i, "v": int(rng.integers(0, 1000))}
                           ).encode()
        part = None if rng.random() < 0.5 else int(rng.integers(0, 3))
        out.append((key, value, part))
    return out


def fetched(broker, topic: str, n_parts: int, offset: int = 0,
            max_messages: int = 1000) -> list:
    return [[(m.key, m.value, m.topic, m.partition, m.offset)
             for m in broker.fetch_from(topic, p, offset, max_messages)]
            for p in range(n_parts)]


@pytest.mark.parametrize("seed", [7, 11])
def test_produce_fetch_commit_equal_jax(seed):
    got = {}
    for name, mod in PKG.items():
        b = mod.MemoryBroker(n_partitions=3)
        for key, value, part in messages(seed, 60):
            b.produce("t", key, value, partition=part)
        b.produce("t", b"", None)  # a tombstone value fetches as b""
        b.commit("g", "t", 1, 5)
        got[name] = (fetched(b, "t", 3), fetched(b, "t", 3, offset=4,
                                                 max_messages=3),
                     b.size("t"), b.committed_offset("g", "t", 1),
                     b.committed_offset("g", "t", 2))
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("seed", [7, 11])
def test_staged_publish_supersede_and_stale_epoch_equal_jax(seed):
    msgs = messages(seed, 24)
    got = {}
    for name, mod in PKG.items():
        b = mod.MemoryBroker(n_partitions=2)
        for key, value, _ in msgs[:6]:
            b.produce("t", key, value, partition=0)
        first = [("t", p, k, v) for k, v, p in msgs[6:14]]
        again = [("t", p, k, v) for k, v, p in msgs[14:20]]
        log = [b.publish_part("op/t/0", 1, first), fetched(b, "t", 2)]
        # a republish at a newer epoch supersedes in place: the earlier
        # publish's offsets hold tombstones, later offsets stay put
        log += [b.publish_part("op/t/0", 2, again), fetched(b, "t", 2),
                fetched(b, "t", 2, offset=3), b.size("t")]
        with pytest.raises(STALE[name]) as e:
            b.publish_part("op/t/0", 1, first)
        log += [str(e.value), fetched(b, "t", 2), b.size("t"),
                b.publish_part("op/t/1", 1, []), b.size("t")]
        got[name] = log
    assert got["port"] == got["jax"]


def test_get_broker_is_per_id():
    for mod in PKG.values():
        a = mod.get_broker("test-torch-mq-a", 2)
        assert mod.get_broker("test-torch-mq-a") is a
        assert mod.get_broker("test-torch-mq-b") is not a
        assert a.n_partitions == 2


def sink_batch(pkg: str, start: int, n: int):
    if pkg == "port":
        return make_batch("users", TableID("sample", "users"), start, n, 3)
    return ref_make_batch("users", RefTableID("sample", "users"), start,
                          n, 3)


def make_sinker(pkg: str, broker_id: str, **kw):
    mod = PKG[pkg]
    params = mod.MQTargetParams(broker_id=broker_id, n_partitions=2, **kw)
    if pkg == "port":
        return mod.MQSinker(params, device="cpu")
    return mod.MQSinker(params)


def all_messages(mod, broker_id: str, topic: str) -> list:
    return fetched(mod.get_broker(broker_id), topic, 2)


@pytest.mark.parametrize("partition_by", ["", "id"])
def test_sinker_push_and_staged_part_equal_jax(partition_by):
    got = {}
    for name, mod in PKG.items():
        broker_id = f"test-torch-mq-sink-{name}-{partition_by or 'key'}"
        mod._BROKERS.pop(broker_id, None)
        sink = make_sinker(name, broker_id, partition_by=partition_by)
        sink.push(sink_batch(name, 0, 16))
        sink.begin_part("op/sample.users/0", 1)
        sink.push(sink_batch(name, 16, 16))
        # a retried push replays the part's rows: the dedup window drops
        # them before publish
        sink.note_push_retry()
        sink.push(sink_batch(name, 16, 16))
        n1 = sink.publish_part("op/sample.users/0", 1)
        dropped1 = sink.last_dedup_dropped
        # the part's retry under a newer epoch supersedes the first one
        sink.begin_part("op/sample.users/0", 2)
        sink.push(sink_batch(name, 16, 8))
        n2 = sink.publish_part("op/sample.users/0", 2)
        sink.begin_part("op/sample.users/0", 1)
        sink.push(sink_batch(name, 16, 4))
        with pytest.raises(STALE[name]):
            sink.publish_part("op/sample.users/0", 1)
        sink.abort_part("op/sample.users/0")
        with pytest.raises(RuntimeError, match="no open stage"):
            sink.publish_part("op/sample.users/0", 3)
        got[name] = (n1, dropped1, n2,
                     all_messages(mod, broker_id, "sample.users"),
                     mod.get_broker(broker_id).size("sample.users"))
        mod._BROKERS.pop(broker_id, None)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 16 and got["port"][2] == 8
    assert got["port"][4] == 16 + 8


def test_client_fetch_commit_seek_equal_jax():
    got = {}
    for name, mod in PKG.items():
        broker_id = f"test-torch-mq-client-{name}"
        mod._BROKERS.pop(broker_id, None)
        b = mod.get_broker(broker_id, 2)
        for i in range(10):
            b.produce("t", str(i).encode(), str(i).encode(),
                      partition=i % 2)
        b.commit("g", "t", 0, 1)
        params = mod.MQSourceParams(broker_id=broker_id, topic="t",
                                    group="g", n_partitions=2)
        c = mod._MQClient(params)
        first = [(f.topic, f.partition, [m.offset for m in f.messages])
                 for f in c.fetch(max_messages=3)]
        c.commit("t", 1, 2)
        c.seek("t", 0, 0)
        c.seek("other", 1, 0)  # another topic's seek is ignored
        second = [(f.topic, f.partition, [m.offset for m in f.messages])
                  for f in c.fetch()]
        got[name] = (first, second, dict(b.committed), dict(c.positions))
        mod._BROKERS.pop(broker_id, None)
    assert got["port"] == got["jax"]


def delivered_rows(store) -> list:
    rows = []
    for b in store.batches:
        d = b.to_pydict()
        rows += sorted(zip(*(d[k] for k in sorted(d))))
    return sorted(rows)


@pytest.mark.parametrize("messages_n", [40, 300])
def test_mq_to_memory_replication_with_the_mask_equals_jax(messages_n):
    """The chaos runner's replication transfer (an mq source of two
    partitions, the JSON parser, a mask_field step, a memory sink)
    through each package's `run_replication`, fault-free: the delivered
    rows and their row keys are the JAX package's."""
    got = {}
    for name, runner, store_of, cp_cls in (
            ("port", port_runner, get_store, MemoryCoordinator),
            ("jax", ref_runner, ref_get_store, RefCoordinator)):
        broker_id = f"test-torch-mq-repl-{name}-{messages_n}"
        sink_id = f"test-torch-mq-repl-{name}"
        runner._seed_broker(broker_id, messages_n)
        store = store_of(sink_id)
        store.clear()
        transfer = runner._replication_transfer(broker_id, sink_id)
        kw = {"device": "cpu"} if name == "port" else {}
        restarts, err = runner._run_replication(
            transfer, cp_cls(), store, messages_n, 60.0, **kw)
        assert err is None and restarts == 0, err
        ref = runner.DeliveryReference.from_batches(store.batches, **kw)
        got[name] = (delivered_rows(store), ref.fingerprint, ref.rows)
        store.clear()
        PKG[name]._BROKERS.pop(broker_id, None)
    assert got["port"] == got["jax"]
    assert got["port"][2] == messages_n
