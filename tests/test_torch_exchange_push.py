"""The port's HttpExchange producer side (the cases of
tests/test_exchange_push.py): the one-K20 hash repartition with host
segments, the self-delivery short circuit (no HTTP, no serde), one
serialization per broadcast, and no empty pages. Everything is
exact."""

import numpy as np
import torch

import presto_tpu_torch.server.node as node_mod
from presto_tpu_torch.batch import Batch
from presto_tpu_torch.parallel.shuffle import partition_dest, partition_key_hash
from presto_tpu_torch.server.node import ExchangeRegistry, HttpExchange
from presto_tpu_torch.server.serde import batch_from_bytes
from presto_tpu_torch.types import BIGINT

CPU = torch.device("cpu")


def _batch(n=100, seed=0):
    rng = np.random.default_rng(seed)
    return Batch.from_numpy({"k": rng.integers(0, 1000, size=n),
                             "v": rng.integers(0, 10, size=n)},
                            {"k": BIGINT, "v": BIGINT})


def _pairs(b):
    d = b.to_pydict()
    return list(zip(d["k"], d["v"]))


def _drain(ex, consumer):
    rows = []
    while True:
        b = ex.pop(consumer)
        if b is None:
            return rows
        assert b.device == CPU
        rows.extend(_pairs(b))


def test_self_delivery_no_http(monkeypatch):
    """Every consumer is this process: a push touches neither http_post
    nor the serde."""
    def boom(*a, **kw):
        raise AssertionError("HTTP or serde used for self-delivery")
    monkeypatch.setattr(node_mod, "http_post", boom)
    monkeypatch.setattr(node_mod, "batch_to_bytes", boom)
    registry = ExchangeRegistry()
    me = "http://127.0.0.1:7"
    ex = HttpExchange("q:0", "repartition", ["k"], None, [None],
                      [me, me, me], 1, registry, self_url=me, device=CPU)
    b = _batch()
    ex.push(0, b)
    ex.producer_done(0)
    got = []
    for c in range(3):
        assert registry.finished("q:0", c) or registry.has_output("q:0", c)
        got.extend(_drain(ex, c))
        assert registry.finished("q:0", c)
    assert sorted(got) == sorted(_pairs(b))


def test_segments_route_by_hash(monkeypatch):
    """Rows land on the consumer their key hashes to; remote consumers
    receive serialized segments, local ones host batches."""
    posts = []
    monkeypatch.setattr(node_mod, "http_post",
                        lambda url, body, timeout=60.0: posts.append(
                            (url, body)))
    registry = ExchangeRegistry()
    me, other = "http://127.0.0.1:7", "http://127.0.0.1:8"
    ex = HttpExchange("q:1", "repartition", ["k"], None, [None],
                      [me, other], 1, registry, self_url=me, device=CPU)
    b = _batch(200, seed=1)
    ex.push(0, b)
    local_rows = _drain(ex, 0)
    remote_rows = []
    for url, body in posts:
        assert url.startswith(other) and "producer=0&seq=" in url
        remote_rows.extend(_pairs(batch_from_bytes(body)))
    assert sorted(local_rows + remote_rows) == sorted(_pairs(b))
    dest = partition_dest(partition_key_hash(b, ["k"], None), 2)
    k_to_dest = dict(zip(b.columns["k"].data.tolist(), dest.tolist()))
    assert all(k_to_dest[k] == 0 for k, _ in local_rows)
    assert all(k_to_dest[k] == 1 for k, _ in remote_rows)


def test_broadcast_serializes_once(monkeypatch):
    """Broadcast to R remote consumers: ONE serialization, R posts."""
    calls = {"serde": 0}
    real = node_mod.batch_to_bytes

    def counting(batch, assume_compact=False):
        calls["serde"] += 1
        return real(batch, assume_compact)
    posts = []
    monkeypatch.setattr(node_mod, "batch_to_bytes", counting)
    monkeypatch.setattr(node_mod, "http_post",
                        lambda url, body, timeout=60.0: posts.append(url))
    ex = HttpExchange("q:2", "broadcast", [], None, [],
                      ["http://a:1", "http://a:2", "http://a:3"], 1,
                      ExchangeRegistry(), self_url=None, device=CPU)
    ex.push(0, _batch(50))
    assert calls["serde"] == 1
    assert len(posts) == 3


def test_empty_segments_not_sent(monkeypatch):
    """Consumers with no rows receive nothing (no empty-page posts)."""
    posts = []
    monkeypatch.setattr(node_mod, "http_post",
                        lambda url, body, timeout=60.0: posts.append(url))
    b = Batch.from_numpy({"k": np.full(64, 7), "v": np.arange(64)},
                         {"k": BIGINT, "v": BIGINT})
    ex = HttpExchange("q:3", "repartition", ["k"], None, [None],
                      [f"http://a:{i}" for i in range(8)], 1,
                      ExchangeRegistry(), device=CPU)
    ex.push(0, b)
    assert len(posts) == 1


def test_registry_dedups_retried_pushes_and_drops_released():
    registry = ExchangeRegistry()
    page = node_mod.batch_to_bytes(_batch(10))
    registry.expect_producers("q9:0", 1)
    registry.receive("q9:0", 0, page, producer=0, seq=0)
    registry.receive("q9:0", 0, page, producer=0, seq=0)  # a retry
    assert registry.pop("q9:0", 0) is not None
    assert registry.pop("q9:0", 0) is None
    registry.drop_query("q9")
    registry.receive("q9:0", 0, page, producer=0, seq=1)  # a straggler
    assert not registry._queues.get(("q9:0", 0))
    assert not registry._expected
