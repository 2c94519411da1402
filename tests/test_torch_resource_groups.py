"""The port's resource groups (presto_tpu_torch/execution/
resource_groups.py) on the cases of tests/test_resource_groups.py:
per-level concurrency caps, queue bounds and structured rejections,
memory caps, weighted-fair and per-user round-robin dispatch, queue
deadlines; and a live port Coordinator with two groups, where one
saturated group must not starve the other."""

import threading
import time

import pytest

from presto_tpu_torch.execution import resource_groups as rg
from presto_tpu_torch.execution.resource_groups import (
    GroupSpec, QueryRejected, ResourceGroupManager, Selector,
)


def two_group_manager(**adhoc):
    root = GroupSpec("root", hard_concurrency=10, max_queued=100,
                     subgroups=[
                         GroupSpec("etl", hard_concurrency=2,
                                   max_queued=2, weight=1),
                         GroupSpec("adhoc", **{"hard_concurrency": 3,
                                               "max_queued": 5,
                                               "weight": 3, **adhoc}),
                     ])
    return ResourceGroupManager(root, [Selector("etl", source="etl.*"),
                                       Selector("adhoc")])


def test_selector_routing():
    m = two_group_manager()
    assert m.submit("alice", "etl-nightly") == ("run", "etl")
    assert m.submit("bob", "cli") == ("run", "adhoc")


def test_group_isolation():
    """Saturating etl leaves adhoc fully available."""
    m = two_group_manager()
    assert m.submit("a", "etl-1")[0] == "run"
    assert m.submit("a", "etl-2")[0] == "run"
    assert m.submit("a", "etl-3")[0] == "queued"  # etl cap = 2
    for i in range(3):
        assert m.submit("b", "cli")[0] == "run", i  # adhoc cap = 3
    assert m.submit("b", "cli")[0] == "queued"


@pytest.mark.parametrize("case", ["queue_full", "no_selector"])
def test_rejections_are_structured(case):
    """Queue-bound overflow sheds as "queue_full", an unroutable query
    as "rejected"; each counts once into SHEDS."""
    m = two_group_manager()
    if case == "queue_full":
        for _ in range(4):
            m.submit("a", "etl-x")  # 2 run, 2 queue (etl queue cap 2)
        key, call, match = ("queue_full", "etl"), ("a", "etl-5"), "queue"
    else:
        m._selectors = [Selector("etl", source="etl.*")]
        key, call, match = ("rejected", "?"), ("alice", "random"), \
            "no resource group"
    before = rg.SHEDS[key]
    with pytest.raises(QueryRejected, match=match) as ei:
        m.submit(*call)
    assert ei.value.kind == key[0]
    assert rg.SHEDS[key] == before + 1
    # selector-less managers admit everything to the one group
    m2 = ResourceGroupManager(GroupSpec("root", hard_concurrency=2,
                                        max_queued=2))
    assert m2.submit("anyone")[0] == "run"


def test_parent_concurrency_caps_children():
    root = GroupSpec("root", hard_concurrency=2, max_queued=10,
                     subgroups=[GroupSpec("a", hard_concurrency=2,
                                          max_queued=10),
                                GroupSpec("b", hard_concurrency=2,
                                          max_queued=10)])
    m = ResourceGroupManager(root, [Selector("a", user="a"),
                                    Selector("b", user="b")])
    assert m.submit("a")[0] == "run"
    assert m.submit("b")[0] == "run"
    # both leaves have headroom but the ROOT cap of 2 is reached
    assert m.submit("a")[0] == "queued"
    assert m.submit("b")[0] == "queued"


def _memory_manager():
    root = GroupSpec("root", hard_concurrency=10, max_queued=10,
                     memory_limit_bytes=100,
                     subgroups=[GroupSpec("g", hard_concurrency=10,
                                          max_queued=10)])
    return ResourceGroupManager(root, [Selector("g")])


@pytest.mark.parametrize("case", ["oversized", "gates"])
def test_memory_caps(case):
    m = _memory_manager()
    if case == "oversized":
        # a reservation no draining can satisfy fails at submit instead
        # of wedging the leaf's queue head
        with pytest.raises(QueryRejected, match="exceeds group"):
            m.submit("u", memory_bytes=200)
        assert m.submit("u", memory_bytes=50)[0] == "run"
    else:
        assert m.submit("u", memory_bytes=60)[0] == "run"
        assert m.submit("u", memory_bytes=60)[0] == "queued"  # 120 > 100
        m.finish("g", memory_bytes=60)
        snap = {r["group"]: r for r in m.snapshot()}
        assert snap["g"]["running"] == 1 and snap["g"]["queued"] == 0


def test_release_dispatches_queued():
    m = two_group_manager()
    m.submit("a", "etl-1")
    m.submit("a", "etl-2")
    fired = threading.Event()
    assert m.submit("a", "etl-3", on_dispatch=fired.set)[0] == "queued"
    m.finish("etl")
    assert fired.wait(1.0)
    snap = {r["group"]: r for r in m.snapshot()}
    assert snap["etl"]["running"] == 2 and snap["etl"]["queued"] == 0


def test_weighted_fair_dispatch():
    """Releases at the ROOT drain the leaf with the lowest
    running/weight first."""
    root = GroupSpec("root", hard_concurrency=2, max_queued=20,
                     subgroups=[
                         GroupSpec("light", hard_concurrency=2,
                                   max_queued=10, weight=1),
                         GroupSpec("heavy", hard_concurrency=2,
                                   max_queued=10, weight=4),
                     ])
    m = ResourceGroupManager(root, [Selector("light", user="l.*"),
                                    Selector("heavy", user="h.*")])
    assert m.submit("l1")[0] == "run"
    assert m.submit("h1")[0] == "run"
    order = []
    m.submit("l2", on_dispatch=lambda: order.append("light"))
    m.submit("h2", on_dispatch=lambda: order.append("heavy"))
    m.finish("light")  # light 0/1 = 0 beats heavy 1/4
    assert order == ["light"]
    m.finish("heavy")
    assert order == ["light", "heavy"]


def test_cancel_queued():
    m = two_group_manager()
    m.submit("a", "etl-1")
    m.submit("a", "etl-2")
    cb = lambda: None  # noqa: E731
    m.submit("a", "etl-3", on_dispatch=cb)
    assert m.cancel_queued("etl", cb)
    snap = {r["group"]: r for r in m.snapshot()}
    assert snap["etl"]["queued"] == 0
    assert not m.cancel_queued("etl", cb)


def test_snapshot_hierarchy_and_queued_by_user():
    m = two_group_manager()
    m.submit("a", "etl-x")
    m.submit("b", "cli")
    snap = {r["group"]: r for r in m.snapshot()}
    assert snap["root"]["running"] == 2  # aggregates children
    assert snap["etl"]["running"] == 1 and snap["adhoc"]["running"] == 1
    m2 = ResourceGroupManager(GroupSpec("root", hard_concurrency=1,
                                        max_queued=10))
    m2.submit("a")
    for user in ("a", "a", "b"):
        m2.submit(user, on_dispatch=lambda: None)
    snap = {r["group"]: r for r in m2.snapshot()}
    assert snap["root"]["queued_by_user"] == {"a": 2, "b": 1}


@pytest.mark.parametrize("case", ["round_robin", "user_weights"])
def test_per_user_dequeue(case):
    """A heavy user's backlog cannot starve a light user, and
    user_weights buy proportionally more dispatches."""
    if case == "round_robin":
        m = ResourceGroupManager(GroupSpec("root", hard_concurrency=1,
                                           max_queued=20))
        assert m.submit("heavy")[0] == "run"
        order = []
        for i in range(6):
            m.submit("heavy", on_dispatch=lambda i=i: order.append(
                f"heavy-{i}"))
        m.submit("light", on_dispatch=lambda: order.append("light"))
        for _ in range(7):
            m.finish("root")
        assert order == ["heavy-0", "light"] + [f"heavy-{i}"
                                                for i in range(1, 6)]
    else:
        m = ResourceGroupManager(GroupSpec(
            "root", hard_concurrency=1, max_queued=20,
            user_weights={"vip": 2}))
        assert m.submit("std")[0] == "run"
        order = []
        for _ in range(2):
            m.submit("std", on_dispatch=lambda: order.append("std"))
            m.submit("vip", on_dispatch=lambda: order.append("vip"))
        for _ in range(4):
            m.finish("root")
        assert order == ["std", "vip", "vip", "std"]


def test_queued_entry_deadline_expires_without_dispatch():
    m = ResourceGroupManager(GroupSpec("root", hard_concurrency=1,
                                       max_queued=10))
    assert m.submit("u")[0] == "run"
    fired = []
    before = rg.SHEDS["queue_expired", "root"]
    m.submit("stale", on_dispatch=lambda: fired.append("dispatched"),
             deadline=time.monotonic() - 0.001,
             on_expire=lambda: fired.append("expired"))
    m.submit("live", on_dispatch=lambda: fired.append("live"))
    assert fired == ["expired"]  # the next submit's sweep dropped it
    assert rg.SHEDS["queue_expired", "root"] == before + 1
    assert m.expire_queued() == 0
    m.finish("root")
    assert fired == ["expired", "live"]


def test_shed_leaves_no_residue():
    m = ResourceGroupManager(GroupSpec("root", hard_concurrency=1,
                                       max_queued=1))
    m.submit("u")
    m.submit("u", on_dispatch=lambda: None)
    with pytest.raises(QueryRejected):
        m.submit("u")
    m.finish("root")
    m.finish("root")
    snap = {r["group"]: r for r in m.snapshot()}
    assert (snap["root"]["running"], snap["root"]["queued"],
            snap["root"]["memory_reserved"]) == (0, 0, 0)


# -- a live coordinator --------------------------------------------------


@pytest.fixture(scope="module")
def rg_coordinator():
    from presto_tpu_torch.server.coordinator import Coordinator
    from presto_tpu_torch.server.node import Node
    worker = Node(device="cpu")
    worker.start()
    root = GroupSpec("root", hard_concurrency=4, max_queued=10,
                     subgroups=[GroupSpec("etl", hard_concurrency=1,
                                          max_queued=1),
                                GroupSpec("adhoc", hard_concurrency=2,
                                          max_queued=5)])
    coord = Coordinator([worker.url], "tpch", "tiny", resource_groups=root,
                        selectors=[Selector("etl", source="etl"),
                                   Selector("adhoc")], device="cpu")
    coord.start()
    try:
        yield coord
    finally:
        coord.stop()
        worker.stop()


def test_coordinator_group_isolation(rg_coordinator):
    """One slow etl query and one queued behind it; adhoc queries still
    run at once, and a third etl submission overflows etl's queue."""
    from presto_tpu_torch.server.coordinator import StatementClient
    slow_sql = ("select count(*) from lineitem l1, lineitem l2 "
                "where l1.orderkey = l2.orderkey")
    results = {}
    gate = threading.Event()

    def run(tag):
        try:
            _, rows = StatementClient(rg_coordinator.url, user="u",
                                      source="etl").execute(slow_sql,
                                                            timeout=300)
            results[tag] = rows
        except Exception as e:  # noqa: BLE001
            results[tag] = e

    # hold the etl slot: the first query cannot finish before the gate
    real = rg_coordinator.execute

    def gated(sql, **kw):
        gate.wait(60)
        return real(sql, **kw)
    rg_coordinator.execute = gated
    try:
        threads = [threading.Thread(target=run, args=(t,))
                   for t in ("etl1", "etl2")]
        for t in threads:
            t.start()
        deadline = time.time() + 30
        while time.time() < deadline:
            snap = {r["group"]: r
                    for r in rg_coordinator.resource_groups.snapshot()}
            if snap["etl"]["queued"] == 1:
                break
            time.sleep(0.02)
        assert snap["etl"]["running"] == 1 and snap["etl"]["queued"] == 1
        rg_coordinator.execute = real
        _, rows = StatementClient(rg_coordinator.url, user="u",
                                  source="cli").execute(
            "select count(*) from nation", timeout=120)
        assert rows == [[25]]
        with pytest.raises(RuntimeError, match="queue full"):
            StatementClient(rg_coordinator.url, user="u",
                            source="etl").execute(slow_sql, timeout=60)
    finally:
        rg_coordinator.execute = real
        gate.set()
        for t in threads:
            t.join(timeout=300)
    assert results["etl1"] == results["etl2"]
    assert not isinstance(results["etl1"], Exception)
