"""CREATE TABLE AS, INSERT and DROP TABLE on the port's `memory` catalog
(connectors/memory.py, operators/write_ops.py, the runner's write
statements) on the CPU, against the JAX package: the same statement
sequences through both LocalRunners at `tiny`, every result compared
(assert_rows_equal: DOUBLE rel_tol 1e-6, the rest exact). They are the
storage queries of tests/test_array_columns.py and tests/test_unnest.py
(arrays stored as slot columns and scanned back) plus the connector's
own rules: versions, dictionary unification, aborts, the blackhole sink.
"""

import pytest
import torch

from test_tpch_suite import assert_rows_equal

torch.set_num_threads(1)

_R = {}


def _runners():
    if not _R:
        from presto_tpu.runner import LocalRunner as RefRunner
        from presto_tpu_torch.runner import LocalRunner
        _R["ref"] = RefRunner("tpch", "tiny")
        _R["port"] = LocalRunner("tpch", "tiny", device="cpu")
    return _R["ref"], _R["port"]


#: statement sequences: every statement runs through both runners and
#: every result is compared
SEQUENCES = {
    "stores_arrays": [
        "create table memory.default.arrstore as select regionkey, "
        "array_agg(nationkey) a, array_agg(name) nm from nation "
        "group by regionkey",
        "select regionkey, a, nm from memory.default.arrstore "
        "order by regionkey",
        "select cardinality(a) from memory.default.arrstore",
        "select x from memory.default.arrstore t cross join unnest(t.a) "
        "u(x) where t.regionkey = 1 order by x",
        "drop table memory.default.arrstore",
    ],
    "insert_into_array_table": [
        "create table memory.default.arrins as select regionkey, "
        "array_agg(nationkey) a from nation group by regionkey",
        "insert into memory.default.arrins select regionkey + 10, "
        "array_agg(nationkey + 100) a from nation group by regionkey",
        "select regionkey, cardinality(a) from memory.default.arrins "
        "order by regionkey",
        "drop table memory.default.arrins",
    ],
    "unnest_split_column": [
        "drop table if exists memory.default.csvt",
        "create table memory.default.csvt as select * from (values "
        "(1, 'a,b'), (2, 'c'), (3, 'd,e,f')) as t(id, csv)",
        "select id, part from memory.default.csvt cross join "
        "unnest(split(csv, ',')) as u(part) order by id, part",
        "select id, part, ord from memory.default.csvt cross join "
        "unnest(split(csv, ',')) with ordinality as u(part, ord) "
        "order by id, ord",
        "drop table memory.default.csvt",
    ],
    "dynamic_array_length_guards": [
        "drop table if exists memory.default.csvg",
        "create table memory.default.csvg as select * from (values "
        "(1, 'a,b'), (2, 'c,d,e')) as t(id, csv)",
        "select id, contains(split(csv, ','), 'z') nz, "
        "contains(split(csv, ','), 'b') hb, "
        "element_at(split(csv, ','), -1) last_e, "
        "array_join(split(csv, ','), '|') j "
        "from memory.default.csvg order by id",
        "select id, array_min(array[length(csv), 10]) lo, "
        "array_max(array[length(csv), 10]) hi "
        "from memory.default.csvg order by id",
        "select array[1, 2] a from memory.default.csvg",
        "drop table memory.default.csvg",
    ],
    "scalar_ctas_insert_columns_and_strings": [
        "create table memory.default.nat as select nationkey, name, "
        "regionkey from nation where nationkey < 10",
        "insert into memory.default.nat (name, nationkey) select name, "
        "nationkey from nation where nationkey >= 20",
        "select nationkey, name, regionkey from memory.default.nat "
        "order by nationkey",
        "select n.name, r.name from memory.default.nat n join region r "
        "on n.regionkey = r.regionkey order by 1",
        "create table if not exists memory.default.nat as select 1 x",
        "drop table memory.default.nat",
        "drop table if exists memory.default.nat",
    ],
    "ctas_of_aggregate_then_join": [
        "create table memory.default.rev as select custkey, "
        "sum(totalprice) t, count(*) c from orders group by custkey",
        "select c.mktsegment, sum(r.t), sum(r.c) from memory.default.rev r "
        "join customer c on c.custkey = r.custkey group by c.mktsegment "
        "order by 1",
        "drop table memory.default.rev",
    ],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_sequence_matches_reference(name):
    ref, port = _runners()
    for sql in SEQUENCES[name]:
        want = ref.execute(sql)
        got = port.execute(sql)
        assert got.names == want.names, sql
        assert_rows_equal(got.rows(), want.rows(), sql, True)


@pytest.mark.parametrize("sql,match", [
    ("create table memory.default.dup as select 1 a, 2 a", "duplicate"),
    ("insert into memory.default.none select 1", "does not exist"),
    ("drop table memory.default.none", "does not exist"),
    ("create table tpch.tiny.x as select 1 a", "does not support writes"),
])
def test_write_rejections(sql, match):
    from presto_tpu_torch.runner import QueryError
    ref, port = _runners()
    with pytest.raises(Exception):
        ref.execute(sql)
    with pytest.raises(QueryError, match=match):
        port.execute(sql)


def test_insert_rejects_a_mismatched_width():
    """A stored array keeps its width: an INSERT planned at another
    array_agg_width is refused, in both packages."""
    from presto_tpu_torch.runner import QueryError
    ref, port = _runners()
    ctas = ("create table memory.default.w64 as select regionkey, "
            "array_agg(nationkey) a from nation group by regionkey")
    ins = ("insert into memory.default.w64 select regionkey, "
           "array_agg(nationkey) from nation group by regionkey")
    for r in (ref, port):
        r.execute(ctas)
        r.execute("set session array_agg_width = 16")
    try:
        with pytest.raises(Exception, match="capacity"):
            ref.execute(ins)
        with pytest.raises(QueryError, match="capacity"):
            port.execute(ins)
    finally:
        for r in (ref, port):
            r.session.properties.pop("array_agg_width", None)
            r.execute("drop table memory.default.w64")


def test_versions_dictionaries_abort_and_blackhole():
    """The connector's own rules: a process-wide monotonic version per
    committed write (a DROP and re-create never reuses one); string
    columns unified onto one dictionary across appends; abort drops
    only uncommitted appends; the blackhole sink counts and discards."""
    from presto_tpu_torch.batch import Batch
    from presto_tpu_torch.connectors.memory import (
        BlackholeConnector, MemoryConnector,
    )
    from presto_tpu_torch.connectors.spi import TableHandle
    from presto_tpu_torch.schema import ColumnSchema, RelationSchema
    from presto_tpu_torch.types import BIGINT, VARCHAR
    conn = MemoryConnector()
    h = TableHandle("memory", "default", "t")
    schema = RelationSchema([ColumnSchema("k", BIGINT),
                             ColumnSchema("s", VARCHAR, ())])
    conn.page_sink.create_table(h, schema)
    v0 = conn.metadata.table_version(h)
    for keys, strs in (([1, 2], ["b", "a"]), ([3], ["c"])):
        conn.page_sink.append(h, Batch.from_pydict(
            {"k": (keys, BIGINT), "s": (strs, VARCHAR)}))
    conn.page_sink.finish(h)
    v1 = conn.metadata.table_version(h)
    assert v1 > v0
    assert conn.metadata.get_table_schema(h).columns[1].dictionary \
        == ("a", "b", "c")
    split = conn.split_manager.get_splits(h, 4)
    rows = [r for sp in split
            for b in conn.page_source.batches(sp, ["k", "s"], 1024)
            for r in b.to_pylist()]
    assert sorted(rows) == [(1, "b"), (2, "a"), (3, "c")]
    conn.page_sink.append(h, Batch.from_pydict({"k": ([9], BIGINT),
                                                "s": (["z"], VARCHAR)}))
    conn.page_sink.abort(h)
    conn.page_sink.finish(h)
    assert conn.metadata.estimate_row_count(h) == 3
    conn.page_sink.drop_table(h)
    conn.page_sink.create_table(h, schema)
    assert conn.metadata.table_version(h) > v1
    bh = BlackholeConnector()
    conn_h = TableHandle("blackhole", "default", "t")
    bh.page_sink.create_table(conn_h, schema)
    bh.page_sink.append(conn_h, Batch.from_pydict(
        {"k": ([1, 2], BIGINT), "s": (["x", "y"], VARCHAR)}))
    assert bh.written_rows("default", "t") == 2
    assert list(bh.page_source.batches(None, ["k"], 1)) == []


def test_write_retry_does_not_duplicate_rows():
    """A CTAS whose join overflows its output capacity is re-run: the
    first run's appends are dropped before the re-run (the sink's
    abort), so the table holds each row once."""
    from presto_tpu_torch.runner import LocalRunner
    port = LocalRunner("tpch", "tiny", {"join_expansion_factor": 1},
                       device="cpu")
    port.execute("create table memory.default.fan as select o.orderkey, "
                 "l.linenumber from orders o join lineitem l "
                 "on o.orderkey = l.orderkey where o.orderkey < 200")
    n = port.execute("select count(*) from memory.default.fan").rows()
    want = port.execute("select count(*) from lineitem "
                        "where orderkey < 200").rows()
    assert n == want
