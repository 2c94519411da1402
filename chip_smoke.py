#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (presto_tpu_torch) on one NVIDIA
GPU: build its hand-written kernels, hold each against its plain PyTorch
version at the shapes the main path gives it, run TPC-H Q1, Q3, Q4, Q5,
Q6, Q11, Q13, Q15, Q16, Q18, Q20, Q21 and Q22, a FULL OUTER join, a
SELECT DISTINCT and a UNION at SF1, and Q19 at `tiny` (at SF1 its cross
product passes the reference's 2^24-slot guard, which the script checks
is raised), through LocalRunner, and check the rows against a numpy
oracle. Q22 keeps no row at SF1 and Q19 none at `tiny`, so Q22_EXISTS
and Q19_LIVE, their plans with predicates that keep rows, are checked
too. Then the sort path (`run_sort_phases`): ORDER_LINES (every
lineitem at SF1, 6,000,012 rows, ordered by extendedprice desc,
orderkey, linenumber), TOPN_LINES (the same ORDER BY, LIMIT 100: one
topn step per batch) and LIMIT_SCAN (a count over a 5,000,000-row LIMIT
that spans five batches), each against a numpy oracle (np.lexsort; the
count exactly), with K24-K27 held against their plain versions at their
largest calls and sort_batch, topn_step and limit_batch timed beside the
same functions through the plain versions; K25 is also held against its
plain version and one stable torch.sort at Q21's lineitem build, its
largest call of the TPC-H path. Then the window path: WIN_RUNNING,
WIN_RANK, WIN_TOPN and
WIN_FRAMES over lineitem and orders at SF1, and TPC-DS Q12, Q20, Q98,
Q36 (a rollup: GroupId) and the q67-shape rank (Q104) at sf1, each
against a numpy oracle, with K13-K16 held against their plain versions
at their largest call (`run_window_phases`). Then the array path:
array_agg / map_agg over lineitem and orders, UNNEST back to every
lineitem, a CREATE TABLE AS of arrays into the memory catalog read
back and dropped, a 9-key grouping and a 9-key join, and round with a
column scale, at SF1, each against a numpy oracle read from the result
batches, with K17 held against its plain version at its largest call
(`run_array_phases`). Last the distributed path: MeshRunner with eight
workers on the one card runs Q1, Q3, Q4, Q5, Q6, Q18, the wave
collision query and a 1,500,000-row ORDER BY merged from per-task runs
at SF1 (every join repartitioned), each against its numpy oracle, with
its waves, rows and bytes across the exchanges and its K12 / K18 / K19
launches; K18 (exchange_shuffle) is held against its plain version at
the largest wave and K19 (merge_pair) at the largest merge, with one
stable torch.sort of the two runs' leading key as K19's library figure
(`run_mesh_phases`). Last the control plane (`run_server_phases`): two
worker processes (`python -m presto_tpu_torch.server.node`) on the card
and a Coordinator in this process run Q1, Q3, Q5, Q6, Q18 and DF_JOIN
at SF1 cold and warm, each against its numpy oracle, with the pages
and bytes pushed over HTTP, the local deliveries and K20-K23's launches
read from every worker's /v1/info around the cold run (each worker's
K20 launches must equal its keyed pushes, and a query with a dynamic
filter must launch K21, K22 and K23); then Q6 through StatementClient
and a count through `python -m presto_tpu_torch.cli --server`; then
Q18 and Q3 with the workers restarted at `--devices 4`; K20
(exchange_partition) is held against its plain version at Q18's
largest keyed push, captured in an in-process cluster, with one stable
torch.sort of the destination vector as its library figure. K21-K23
(the dynamic filter's bounds, set and apply) are held against their
plain versions at their largest calls on the TPC-H path.

    python3 chip_smoke.py

Each phase prints one JSON line. The line before the last is the
per-kernel summary ({"kernels": [...]}), the line before that the
card's name and power limit from nvidia-smi, and the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before that
last line. The script needs a CUDA device, nvcc (CUDA_HOME,
/usr/local/cuda or PATH) and the repository beside it; it imports
nothing of JAX.

Main path: LocalRunner("tpch", "sf1", properties={"batch_rows": 1<<20})
executes each query cold with every kernel's launch counter set to 0
just before the query and read just after (those counts are the
"launches" of the summary line, summed over both paths), then warm:
once on the TPC-H path (EARLIER_WARM, to keep the script inside its
time), three times on the window path (WINDOW_WARM, the median). It runs with
the defaults, so whole-fragment fusion is on: every query launches
K12, no chain runs its composed form on the card, and no fusion report
holds a `not_lowered` reason; each query's line gives its fused / total
chains, the fusion pass's decisions as the FUSED_FRAGMENTS counter
counted them, and the Triton compiles (count, seconds) inside its cold
wall. The kernels (KERNELS below): K1 direct_slot_reduce, K2
compact, K3 row_hash, K4 join_build, K5 join_probe, K6 segment_reduce,
K7 semi_join, K8 stream_reduce, K9 join_expand (with its full mode), K10
cross_product, K11 join_outer, K13-K16 (window), K17 array_collect,
K18 exchange_shuffle, K19 merge_pair, K20 exchange_partition, K22-K23
(the dynamic filter's set and apply), K24 sort_encode, K25 radix_sort,
K26 gather_rows and K27 limit_rank, K28 state_shrink, K29 agg_finalize
and K30 vector_reduce (CUDA C++, built with nvcc; K3 and K26 reading a
merge's partial states as sources count also as row_hash_sources and
gather_rows_sources), K21 (a Triton kernel),
and K12 fragment (a Triton kernel generated per filter/project chain at
its first launch). Q1, Q3, Q6 and Q18 also run with fusion off (their
FilterProjects as one-stage K12 kernels), rows checked and walls beside
the fused ones. The kernel measurements run on inputs captured from a
separate run of the same queries (the largest call of each kernel; K9
per layout and in full mode at the FULL join's largest call; K10 at
the calls of K10_AT; the DISTINCT fold, K3 + K25 + K26 + K6, at
the DISTINCT query's largest call), so their shapes are the main path's;
compact is also measured on a 1M-row lineitem batch at ~2% and ~98%
live. Launches made while comparing or timing are not counted. K4
also reports one stable torch.sort of the build hashes, K6 the time of
the K25 sort of (h1, h2) that precedes it on the main path. K12 is
held against its composed form at the largest call
of every distinct generated kernel, fused and fusion off (every kernel
launched in the run is compared), and timed at the three largest by
bytes and at Q1's chain fused into its aggregation, from a cold L2: each
timed call reads one of several copies of its batch, which together
overflow the L2 (the warm device time, one batch again and again, is
reported beside it). The aggregation state's calls (AGG_CALLS) are
held against their plain versions at their largest call on the TPC-H
path: merge_states (K3 and K26 reading the partial states as sources,
K25, K6, K30) against the concatenating composition, and K3 and K26
over those sources alone; _shrink_state (K28) against a plain copy,
each shrunk array owning storage of its size; _count_live (the count
K6 carried, no reduction) against a sum and its copy, and one
count_nonzero; finalize and direct_finalize (K29, one launch per
drain) against the composed drains. Then the aggregation path
(`run_agg_phases`): APPROX_DIRECT, APPROX_GROUPED and APPROX_GLOBAL
(approx_percentile, approx_distinct, checksum) at SF1, each against a
numpy oracle that builds the same sketches (the reference's bucket
function and hash, compared exactly) and against the exact answers
within the sketches' errors, with cold and warm walls and peak device
memory; K30 (vector_reduce) is held against its plain version at its
largest call of each mode (direct, sparse, dense merge). The profile
phase counts the CUDA kernel launches of one warm execution of each
query (and of Q1, Q3 and Q6 with fusion off). Every kernel of the
summary line must have been launched on some path.

Tolerances: K2 (compact), K3, K4, K5, K7 (semi_join) and K24-K27 must
match their plain versions exactly (row order, hashes, offsets, slots,
key words, permutations, moved rows and keep masks are the result). K1
(direct_slot_reduce) integers must match exactly;
float64 components to a relative 1e-9, because atomics add in a
run-dependent order. K6 (segment_reduce) and K8 (stream_reduce) group
counts, first rows, keys, carry flags, the overflow flag and integer
components exactly, float64 components to a relative 1e-9 (a
lane-strided tree order against the plain version's row order). K9
(join_expand): liveness, masks, every value under a set mask, the
overflow flag and the live count exactly; in full mode the matched
flags exactly too. K10 (cross_product) and K11 (join_outer): liveness,
masks and every value under a set mask exactly (they copy). The DISTINCT
fold: the kept rows, their order and their masks exactly (both sort by
the same hashes). K12 (fragment): row_valid, masks and every value under
a set mask exactly (FMA contraction off, IEEE division, floored integer
division, as the composed form computes). K13 (window_segments), K15
(window_frame_minmax) and K16 (window_emit): every position, value and
mask exactly (NaN equal to NaN); K28 (state_shrink) and K30
(vector_reduce): exactly (copies; integer sums and maxima); K29
(agg_finalize): liveness, masks and integer values exactly, float values
reported as max_abs_err (the same IEEE operations, each rounded on its
own); merge_states: groups, keys, live count and integer states
exactly, float states as max_abs_err; K18 (exchange_shuffle) and K19
(merge_pair): every consumer's or the merged batch's row_valid, masks
and values exactly, in order (NaN equal to NaN); K14 (window_frame_sum): masks, counts
and integer sums exactly, float sums to a relative 1e-9 (both keep
double-double prefixes, combined in another order). Query results:
DOUBLE columns to a relative 1e-6 (the
repository's TPC-H comparison rule), everything else exact, in the
query's order (as a multiset where the query has no ORDER BY; Q11 as a
multiset whose rows come in descending value; TPC-DS Q36's rows equal
on its ORDER BY keys as a multiset, since a data group whose class is
NULL ties with its category's rollup row).
"""

import collections
import itertools
import json
import statistics
import subprocess
import sys
import time

SCHEMA = "sf1"
PROPS = {"batch_rows": 1 << 20}
#: H100 SXM HBM3 bandwidth (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
WARMUP, ITERS = 3, 25
#: relative limit of merge_states' float components against the plain
#: merge (two orders of the same few additions per group)
MERGE_RTOL = 1e-12
#: warm executions per query: the earlier slices' TPC-H path runs one
#: (to keep the script inside its time), the window and TPC-DS path
#: the median of three
EARLIER_WARM, WINDOW_WARM = 1, 3

Q1 = """select
    returnflag, linestatus,
    sum(quantity) as sum_qty,
    sum(extendedprice) as sum_base_price,
    sum(extendedprice * (1 - discount)) as sum_disc_price,
    sum(extendedprice * (1 - discount) * (1 + tax)) as sum_charge,
    avg(quantity) as avg_qty,
    avg(extendedprice) as avg_price,
    avg(discount) as avg_disc,
    count(*) as count_order
from lineitem
where shipdate <= date '1998-09-02'
group by returnflag, linestatus
order by returnflag, linestatus"""

Q6 = """select sum(extendedprice * discount) as revenue
from lineitem
where shipdate >= date '1994-01-01'
  and shipdate < date '1995-01-01'
  and discount between 0.05 and 0.07
  and quantity < 24"""


Q3 = """select
    l.orderkey,
    sum(l.extendedprice * (1 - l.discount)) as revenue,
    o.orderdate, o.shippriority
from customer c, orders o, lineitem l
where c.mktsegment = 'BUILDING'
  and c.custkey = o.custkey
  and l.orderkey = o.orderkey
  and o.orderdate < date '1995-03-15'
  and l.shipdate > date '1995-03-15'
group by l.orderkey, o.orderdate, o.shippriority
order by revenue desc, o.orderdate
limit 10"""

Q5 = """select
    n.name, sum(l.extendedprice * (1 - l.discount)) as revenue
from customer c, orders o, lineitem l, supplier s, nation n, region r
where c.custkey = o.custkey
  and l.orderkey = o.orderkey
  and l.suppkey = s.suppkey
  and c.nationkey = s.nationkey
  and s.nationkey = n.nationkey
  and n.regionkey = r.regionkey
  and r.name = 'ASIA'
  and o.orderdate >= date '1994-01-01'
  and o.orderdate < date '1995-01-01'
group by n.name
order by revenue desc"""

Q13 = """select c_count, count(*) as custdist
from (
    select c.custkey as c_custkey, count(o.orderkey) as c_count
    from customer c left outer join orders o
      on c.custkey = o.custkey
     and o.comment not like '%special%requests%'
    group by c.custkey
) c_orders
group by c_count
order by custdist desc, c_count desc"""

Q4 = """select o.orderpriority, count(*) as order_count
from orders o
where o.orderdate >= date '1993-07-01'
  and o.orderdate < date '1993-10-01'
  and exists (
        select * from lineitem l
        where l.orderkey = o.orderkey
          and l.commitdate < l.receiptdate)
group by o.orderpriority
order by o.orderpriority"""

Q16 = """select p.brand, p.type, p.size,
       count(distinct ps.suppkey) as supplier_cnt
from partsupp ps, part p
where p.partkey = ps.partkey
  and p.brand <> 'Brand#45'
  and p.type not like 'MEDIUM POLISHED%'
  and p.size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps.suppkey not in (
        select suppkey from supplier
        where comment like '%Customer%Complaints%')
group by p.brand, p.type, p.size
order by supplier_cnt desc, p.brand, p.type, p.size"""

Q18 = """select c.name, c.custkey, o.orderkey, o.orderdate, o.totalprice,
       sum(l.quantity) as total_qty
from customer c, orders o, lineitem l
where o.orderkey in (
        select orderkey
        from lineitem
        group by orderkey
        having sum(quantity) > 300)
  and c.custkey = o.custkey
  and o.orderkey = l.orderkey
group by c.name, c.custkey, o.orderkey, o.orderdate, o.totalprice
order by o.totalprice desc, o.orderdate
limit 100"""

Q20 = """select s.name, s.address
from supplier s, nation n
where s.suppkey in (
        select ps.suppkey
        from partsupp ps
        where ps.partkey in (
                select partkey from part
                where name like 'forest%')
          and ps.availqty > (
                select 0.5 * sum(l.quantity)
                from lineitem l
                where l.partkey = ps.partkey
                  and l.suppkey = ps.suppkey
                  and l.shipdate >= date '1994-01-01'
                  and l.shipdate < date '1995-01-01'))
  and s.nationkey = n.nationkey
  and n.name = 'CANADA'
order by s.name"""

Q11 = """select ps.partkey, sum(ps.supplycost * ps.availqty) as value
from partsupp ps, supplier s, nation n
where ps.suppkey = s.suppkey
  and s.nationkey = n.nationkey
  and n.name = 'GERMANY'
group by ps.partkey
having sum(ps.supplycost * ps.availqty) > (
    select sum(ps2.supplycost * ps2.availqty) * 0.0001
    from partsupp ps2, supplier s2, nation n2
    where ps2.suppkey = s2.suppkey
      and s2.nationkey = n2.nationkey
      and n2.name = 'GERMANY')
order by value desc"""

Q15 = """with revenue0 as (
    select suppkey as supplier_no,
           sum(extendedprice * (1 - discount)) as total_revenue
    from lineitem
    where shipdate >= date '1996-01-01'
      and shipdate < date '1996-04-01'
    group by suppkey
)
select s.suppkey, s.name, s.address, s.phone, r.total_revenue
from supplier s, revenue0 r
where s.suppkey = r.supplier_no
  and r.total_revenue = (select max(total_revenue) from revenue0)
order by s.suppkey"""

Q19 = """select sum(l.extendedprice * (1 - l.discount)) as revenue
from lineitem l, part p
where (
        p.partkey = l.partkey
    and p.brand = 'Brand#12'
    and p.container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
    and l.quantity >= 1 and l.quantity <= 11
    and p.size between 1 and 5
    and l.shipmode in ('AIR', 'AIR REG')
    and l.shipinstruct = 'DELIVER IN PERSON'
) or (
        p.partkey = l.partkey
    and p.brand = 'Brand#23'
    and p.container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
    and l.quantity >= 10 and l.quantity <= 20
    and p.size between 1 and 10
    and l.shipmode in ('AIR', 'AIR REG')
    and l.shipinstruct = 'DELIVER IN PERSON'
) or (
        p.partkey = l.partkey
    and p.brand = 'Brand#34'
    and p.container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
    and l.quantity >= 20 and l.quantity <= 30
    and p.size between 1 and 15
    and l.shipmode in ('AIR', 'AIR REG')
    and l.shipinstruct = 'DELIVER IN PERSON'
)"""

Q21 = """select s.name, count(*) as numwait
from supplier s, lineitem l1, orders o, nation n
where s.suppkey = l1.suppkey
  and o.orderkey = l1.orderkey
  and o.orderstatus = 'F'
  and l1.receiptdate > l1.commitdate
  and exists (
        select * from lineitem l2
        where l2.orderkey = l1.orderkey
          and l2.suppkey <> l1.suppkey)
  and not exists (
        select * from lineitem l3
        where l3.orderkey = l1.orderkey
          and l3.suppkey <> l1.suppkey
          and l3.receiptdate > l3.commitdate)
  and s.nationkey = n.nationkey
  and n.name = 'SAUDI ARABIA'
group by s.name
order by numwait desc, s.name
limit 100"""

Q22 = """select cntrycode, count(*) as numcust, sum(acctbal) as totacctbal
from (
    select substring(c.phone, 1, 2) as cntrycode, c.acctbal
    from customer c
    where substring(c.phone, 1, 2) in
            ('13', '31', '23', '29', '30', '18', '17')
      and c.acctbal > (
            select avg(c2.acctbal)
            from customer c2
            where c2.acctbal > 0.00
              and substring(c2.phone, 1, 2) in
                    ('13', '31', '23', '29', '30', '18', '17'))
      and not exists (
            select * from orders o
            where o.custkey = c.custkey)
) custsale
group by cntrycode
order by cntrycode"""

#: Q22 keeps no row at SF1 (the generator gives nearly every customer an
#: order, so NOT EXISTS leaves a handful, none above the average): this
#: variant keeps the customers WITH orders, so its cross product with
#: the one-row average is live
Q22_EXISTS = Q22.replace("and not exists", "and exists")

#: Q19 keeps no line at `tiny` (its result is one NULL): this variant
#: keeps Q19's plan, a cross join with an OR-predicate above it, with
#: branches wide enough to keep some 1,600 lines
Q19_LIVE = """select sum(l.extendedprice * (1 - l.discount)) as revenue,
       count(*) as lines
from lineitem l, part p
where (
        p.partkey = l.partkey
    and p.size between 1 and 25
    and l.quantity <= 25
) or (
        p.partkey = l.partkey
    and p.brand in ('Brand#12', 'Brand#23', 'Brand#34')
    and l.shipinstruct = 'DELIVER IN PERSON'
)"""

#: a FULL OUTER join whose sides both keep unmatched rows
FULL = """select count(*), count(c.custkey), count(o.orderkey),
       sum(o.totalprice)
from (select custkey from customer where nationkey < 5) c
full join (select orderkey, custkey, totalprice from orders
           where orderpriority = '1-URGENT') o
on c.custkey = o.custkey"""

#: a DISTINCT of some 10^5 pairs, whose state doubles many times
DISTINCT = """select distinct partkey, suppkey from lineitem
where shipdate >= date '1998-01-01'"""

UNION = """select custkey from orders where orderpriority = '1-URGENT'
union
select custkey from customer where acctbal > 9000"""

QUERIES = {"q1": Q1, "q3": Q3, "q5": Q5, "q6": Q6, "q13": Q13, "q4": Q4,
           "q16": Q16, "q18": Q18, "q20": Q20, "q11": Q11, "q15": Q15,
           "q21": Q21, "q22": Q22, "q22_exists": Q22_EXISTS, "full": FULL,
           "distinct": DISTINCT, "union": UNION, "q19": Q19,
           "q19_live": Q19_LIVE}
#: Q19 runs at this scale: at SF1 (and already at sf0_01) its cross
#: product passes 2^24 slots and raises the reference's guard
Q19_SCHEMA = "tiny"
#: queries that run at another scale than SCHEMA
QUERY_SCHEMA = {"q19": Q19_SCHEMA, "q19_live": Q19_SCHEMA}
#: the reference's cross-join guard (presto_tpu/operators/misc_ops.py:97)
GUARD = r"cross join would materialize \d+ rows; add a join condition"


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# -- timing ----------------------------------------------------------------

def time_ms(fn, torch) -> float:
    """Median device time of one call over ITERS calls after WARMUP,
    CUDA events around each call."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# -- the numpy oracle ------------------------------------------------------

def q1_predicate(li, gen_module):
    return li["shipdate"] <= gen_module.parse_date_literal("1998-09-02")


def q6_predicate(li, gen_module):
    days = gen_module.parse_date_literal
    return ((li["shipdate"] >= days("1994-01-01"))
            & (li["shipdate"] < days("1995-01-01"))
            & (li["discount"] >= 0.05) & (li["discount"] <= 0.07)
            & (li["quantity"] < 24))


def lineitem_table(np, gen, cols):
    """Lineitem columns in the connector's order (it generates by order
    index)."""
    norders = gen.rows("orders")
    step = 1 << 18
    parts = [gen.generate("lineitem", lo, min(lo + step, norders))
             for lo in range(0, norders, step)]
    return {c: np.concatenate([p[c] for p in parts]) for c in cols}


def oracle(np, gen_module, schema=SCHEMA):
    """Q1 and Q6 in numpy over the same generated lineitem (the
    connector's generator, chunk by chunk). Returns (Q1 rows, Q6 rows,
    the lineitem columns the oracles read)."""
    gen = gen_module.TpchGenerator(gen_module.TpchConnector.SCHEMAS[schema])
    li = lineitem_table(np, gen, (
        "quantity", "extendedprice", "discount", "tax", "returnflag",
        "linestatus", "shipdate", "orderkey", "suppkey", "partkey",
        "commitdate", "receiptdate"))
    schema = gen.schema("lineitem")
    rf_dic = schema.column("returnflag").dictionary
    ls_dic = schema.column("linestatus").dictionary

    keep = q1_predicate(li, gen_module)
    q1 = []
    for rf in range(len(rf_dic)):
        for ls in range(len(ls_dic)):
            g = keep & (li["returnflag"] == rf) & (li["linestatus"] == ls)
            if not g.any():
                continue
            qty, price = li["quantity"][g], li["extendedprice"][g]
            disc, tax = li["discount"][g], li["tax"][g]
            n = int(g.sum())
            q1.append((rf_dic[rf], ls_dic[ls], float(qty.sum()),
                       float(price.sum()),
                       float((price * (1 - disc)).sum()),
                       float((price * (1 - disc) * (1 + tax)).sum()),
                       float(qty.sum() / n), float(price.sum() / n),
                       float(disc.sum() / n), n))
    sel = q6_predicate(li, gen_module)
    q6 = [(float((li["extendedprice"][sel] * li["discount"][sel]).sum()),)]
    return q1, q6, li


def table(np, gen, name, cols):
    """Columns of a whole generated table, made in chunks."""
    n = gen.rows(name)
    step = 1 << 18
    parts = [gen.generate(name, lo, min(lo + step, n))
             for lo in range(0, n, step)]
    return {c: np.concatenate([p[c] for p in parts]) for c in cols}


def lookup(np, keys, probe):
    """Join `probe` keys to a table whose `keys` are unique, by
    searchsorted on the sorted keys: (matched mask, row of the table)."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    pos = np.clip(np.searchsorted(sk, probe), 0, len(sk) - 1)
    return sk[pos] == probe, order[pos]


def join_oracle(np, gen_module, li, schema=SCHEMA):
    """Q3, Q5 and Q13 in numpy over the same generated tables: joins by
    searchsorted on sorted keys, grouping by np.unique / np.bincount."""
    import re
    gen = gen_module.TpchGenerator(gen_module.TpchConnector.SCHEMAS[schema])
    days = gen_module.parse_date_literal
    cust = table(np, gen, "customer", ("custkey", "mktsegment",
                                       "nationkey"))
    orders = table(np, gen, "orders", ("orderkey", "custkey", "orderdate",
                                       "shippriority", "comment"))
    supp = table(np, gen, "supplier", ("suppkey", "nationkey"))
    nation = table(np, gen, "nation", ("nationkey", "name", "regionkey"))
    region = table(np, gen, "region", ("regionkey", "name"))

    def code(tbl, col, value):
        return gen.schema(tbl).column(col).dictionary.index(value)
    rev = li["extendedprice"] * (1 - li["discount"])
    _, li_order = lookup(np, orders["orderkey"], li["orderkey"])

    # Q3: BUILDING customers' orders before 1995-03-15, lines shipped
    # after it, revenue per order, top 10
    building = cust["custkey"][cust["mktsegment"]
                               == code("customer", "mktsegment",
                                       "BUILDING")]
    o_ok = lookup(np, building, orders["custkey"])[0] \
        & (orders["orderdate"] < days("1995-03-15"))
    lsel = o_ok[li_order] & (li["shipdate"] > days("1995-03-15"))
    okeys, inv = np.unique(li["orderkey"][lsel], return_inverse=True)
    sums = np.bincount(inv, weights=rev[lsel])
    _, orow = lookup(np, orders["orderkey"], okeys)
    q3 = sorted(((int(k), float(r), int(orders["orderdate"][o]),
                  int(orders["shippriority"][o]))
                 for k, r, o in zip(okeys, sums, orow)),
                key=lambda t: (-t[1], t[2]))[:10]

    # Q5: 1994 orders whose customer and supplier share an ASIA nation
    asia = region["regionkey"][region["name"]
                               == code("region", "name", "ASIA")]
    o_ok = (orders["orderdate"] >= days("1994-01-01")) \
        & (orders["orderdate"] < days("1995-01-01"))
    _, crow = lookup(np, cust["custkey"], orders["custkey"][li_order])
    _, srow = lookup(np, supp["suppkey"], li["suppkey"])
    c_nat = cust["nationkey"][crow]
    s_nat = supp["nationkey"][srow]
    _, nrow = lookup(np, nation["nationkey"], s_nat)
    keep = o_ok[li_order] & (c_nat == s_nat) \
        & np.isin(nation["regionkey"][nrow], asia)
    by_nat = np.bincount(nrow[keep], weights=rev[keep],
                         minlength=len(nation["nationkey"]))
    names = gen.schema("nation").column("name").dictionary
    q5 = sorted(((names[nation["name"][i]], float(by_nat[i]))
                 for i in np.unique(nrow[keep])), key=lambda t: -t[1])

    # Q13: orders per customer (comment not like '%special%requests%'),
    # customers per count, zero-order customers included
    special = np.array([re.search("special.*requests", w) is not None
                        for w in gen.schema("orders").column("comment")
                        .dictionary])
    counted = ~special[orders["comment"]]
    hit, crow = lookup(np, cust["custkey"], orders["custkey"][counted])
    c_count = np.bincount(crow[hit], minlength=len(cust["custkey"]))
    vals, dist = np.unique(c_count, return_counts=True)
    q13 = sorted(((int(v), int(d)) for v, d in zip(vals, dist)),
                 key=lambda t: (-t[1], -t[0]))
    return {"q3": q3, "q5": q5, "q13": q13}


def semi_oracle(np, gen_module, li, schema=SCHEMA):
    """Q4, Q16, Q18 and Q20 in numpy over the same generated tables:
    membership by np.isin, grouping by np.unique / np.bincount, string
    predicates evaluated on the dictionaries."""
    import fnmatch
    gen = gen_module.TpchGenerator(gen_module.TpchConnector.SCHEMAS[schema])
    days = gen_module.parse_date_literal
    orders = table(np, gen, "orders", ("orderkey", "custkey", "orderdate",
                                       "totalprice", "orderpriority"))
    cust = table(np, gen, "customer", ("custkey", "name"))
    part = table(np, gen, "part", ("partkey", "name", "brand", "type",
                                   "size"))
    ps = table(np, gen, "partsupp", ("partkey", "suppkey", "availqty"))
    supp = table(np, gen, "supplier", ("suppkey", "name", "address",
                                       "nationkey", "comment"))
    nation = table(np, gen, "nation", ("nationkey", "name"))

    def dic(tbl, col):
        return gen.schema(tbl).column(col).dictionary

    def like(tbl, col, pattern):
        """Per dictionary code: does the string match the LIKE pattern."""
        return np.array([fnmatch.fnmatchcase(w, pattern.replace("%", "*"))
                         for w in dic(tbl, col)])

    # Q4: orders of 1993Q3 with a line received after its commit date
    late = np.unique(li["orderkey"][li["commitdate"] < li["receiptdate"]])
    osel = (orders["orderdate"] >= days("1993-07-01")) \
        & (orders["orderdate"] < days("1993-10-01")) \
        & np.isin(orders["orderkey"], late)
    prio = dic("orders", "orderpriority")
    counts = np.bincount(orders["orderpriority"][osel], minlength=len(prio))
    q4 = [(prio[i], int(c)) for i, c in enumerate(counts) if c]

    # Q16: suppliers per (brand, type, size) of the qualifying parts,
    # without the suppliers with complaints
    bad = supp["suppkey"][like("supplier", "comment",
                               "%Customer%Complaints%")[supp["comment"]]]
    pok = (part["brand"] != dic("part", "brand").index("Brand#45")) \
        & ~like("part", "type", "MEDIUM POLISHED%")[part["type"]] \
        & np.isin(part["size"], [49, 14, 23, 45, 19, 3, 36, 9])
    hit, prow = lookup(np, part["partkey"], ps["partkey"])
    keep = hit & pok[prow] & ~np.isin(ps["suppkey"], bad)
    rows = np.unique(np.stack([part["brand"][prow[keep]],
                               part["type"][prow[keep]],
                               part["size"][prow[keep]],
                               ps["suppkey"][keep]]), axis=1)
    groups, cnt = np.unique(rows[:3], axis=1, return_counts=True)
    brand, ptype = dic("part", "brand"), dic("part", "type")
    q16 = sorted(((brand[b], ptype[t], int(z), int(c))
                  for (b, t, z), c in zip(groups.T, cnt)),
                 key=lambda r: (-r[3], r[0], r[1], r[2]))

    # Q18: orders of more than 300 units, with their customer
    okeys, inv = np.unique(li["orderkey"], return_inverse=True)
    qty = np.bincount(inv, weights=li["quantity"])
    big = qty > 300
    _, orow = lookup(np, orders["orderkey"], okeys[big])
    _, crow = lookup(np, cust["custkey"], orders["custkey"][orow])
    cname = dic("customer", "name")
    q18 = sorted(((cname[cust["name"][c]], int(cust["custkey"][c]),
                   int(orders["orderkey"][o]), int(orders["orderdate"][o]),
                   float(orders["totalprice"][o]), float(q))
                  for o, c, q in zip(orow, crow, qty[big])),
                 key=lambda r: (-r[4], r[3]))[:100]

    # Q20: CANADA suppliers with excess stock of forest parts in 1994
    forest = part["partkey"][like("part", "name", "forest%")[part["name"]]]
    s94 = (li["shipdate"] >= days("1994-01-01")) \
        & (li["shipdate"] < days("1995-01-01"))
    width = int(supp["suppkey"].max()) + 1
    lkey = li["partkey"][s94] * width + li["suppkey"][s94]
    pskey = ps["partkey"] * width + ps["suppkey"]
    lk, linv = np.unique(lkey, return_inverse=True)
    lsum = np.bincount(linv, weights=li["quantity"][s94])
    has, lrow = lookup(np, lk, pskey)
    excess = np.isin(ps["partkey"], forest) & has \
        & (ps["availqty"] > 0.5 * lsum[lrow])
    canada = nation["nationkey"][nation["name"]
                                 == dic("nation", "name").index("CANADA")]
    ssel = np.isin(supp["suppkey"], ps["suppkey"][excess]) \
        & np.isin(supp["nationkey"], canada)
    sname, saddr = dic("supplier", "name"), dic("supplier", "address")
    q20 = sorted((sname[supp["name"][i]], saddr[supp["address"][i]])
                 for i in np.flatnonzero(ssel))
    return {"q4": q4, "q16": q16, "q18": q18, "q20": q20}


def slice4_oracle(np, gen_module, li, schema=SCHEMA):
    """Q11, Q15, Q21, Q22, the FULL join, the DISTINCT and the UNION in
    numpy over the same generated tables: keys are dense (row i holds
    key i + 1), so a lookup is an index; grouping by np.unique /
    np.bincount; string predicates evaluated on the dictionaries."""
    gen = gen_module.TpchGenerator(gen_module.TpchConnector.SCHEMAS[schema])
    days = gen_module.parse_date_literal
    ps = table(np, gen, "partsupp", ("partkey", "suppkey", "availqty",
                                     "supplycost"))
    supp = table(np, gen, "supplier", ("suppkey", "name", "address",
                                       "nationkey", "phone"))
    nation = table(np, gen, "nation", ("nationkey", "name"))
    orders = table(np, gen, "orders", ("orderkey", "custkey", "orderstatus",
                                       "totalprice", "orderpriority"))
    cust = table(np, gen, "customer", ("custkey", "nationkey", "phone",
                                       "acctbal"))
    for t, k in ((supp, "suppkey"), (orders, "orderkey"), (cust, "custkey")):
        assert (t[k] == np.arange(1, len(t[k]) + 1)).all()

    def dic(tbl, col):
        return gen.schema(tbl).column(col).dictionary

    def nation_key(name):
        code = dic("nation", "name").index(name)
        return int(nation["nationkey"][nation["name"] == code][0])

    # Q11: GERMANY's stock value per part above 0.0001 of the total
    german = supp["nationkey"][ps["suppkey"] - 1] == nation_key("GERMANY")
    value = ps["supplycost"][german] * ps["availqty"][german]
    parts, inv = np.unique(ps["partkey"][german], return_inverse=True)
    by_part = np.bincount(inv, weights=value)
    keep = by_part > value.sum() * 0.0001
    q11 = sorted(((int(k), float(v)) for k, v in
                  zip(parts[keep], by_part[keep])), key=lambda r: -r[1])

    # Q15: the suppliers of the largest 1996Q1 revenue
    q1_96 = (li["shipdate"] >= days("1996-01-01")) \
        & (li["shipdate"] < days("1996-04-01"))
    rev = np.bincount(li["suppkey"][q1_96],
                      weights=(li["extendedprice"] * (1 - li["discount"]))
                      [q1_96], minlength=len(supp["suppkey"]) + 1)
    sname, saddr, sphone = (dic("supplier", c)
                            for c in ("name", "address", "phone"))
    q15 = [(int(k), sname[supp["name"][k - 1]],
            saddr[supp["address"][k - 1]], sphone[supp["phone"][k - 1]],
            float(rev[k])) for k in np.flatnonzero(rev == rev.max())]

    # Q21: SAUDI ARABIA suppliers whose late line held up a finished
    # multi-supplier order where no other supplier was late
    ok, sk = li["orderkey"], li["suppkey"]
    late = li["receiptdate"] > li["commitdate"]
    oid = np.cumsum(np.r_[True, ok[1:] != ok[:-1]]) - 1  # sorted by order
    lines = np.bincount(oid)[oid]
    late_lines = np.bincount(oid, weights=late)[oid]
    _, pinv = np.unique(oid * (len(supp["suppkey"]) + 1) + sk,
                        return_inverse=True)
    own = np.bincount(pinv)[pinv]
    own_late = np.bincount(pinv, weights=late)[pinv]
    finished = orders["orderstatus"][ok - 1] \
        == dic("orders", "orderstatus").index("F")
    saudi = supp["nationkey"][sk - 1] == nation_key("SAUDI ARABIA")
    sel = late & finished & saudi & (lines > own) & (late_lines == own_late)
    # grouped by name: suppliers may share one
    wait = np.bincount(supp["name"][sk[sel] - 1], minlength=len(sname))
    q21 = sorted(((sname[c], int(wait[c])) for c in np.flatnonzero(wait)),
                 key=lambda r: (-r[1], r[0]))[:100]

    # Q22: customers of seven country codes, richer than their average,
    # with no order
    phones = dic("customer", "phone")
    codes = ("13", "31", "23", "29", "30", "18", "17")
    prefix = np.array([p[:2] for p in phones])[cust["phone"]]
    in_codes = np.isin(prefix, codes)
    avg = cust["acctbal"][in_codes & (cust["acctbal"] > 0)].mean()
    no_order = ~np.isin(cust["custkey"], orders["custkey"])

    def q22_rows(csel):
        return [(c, int((prefix[csel] == c).sum()),
                 float(cust["acctbal"][csel][prefix[csel] == c].sum()))
                for c in sorted(set(prefix[csel]))]
    q22 = q22_rows(in_codes & (cust["acctbal"] > avg) & no_order)
    q22_exists = q22_rows(in_codes & (cust["acctbal"] > avg) & ~no_order)

    # the FULL join: nation < 5 customers against 1-URGENT orders
    urgent = orders["orderpriority"] \
        == dic("orders", "orderpriority").index("1-URGENT")
    ccust = cust["custkey"][cust["nationkey"] < 5]
    ocust = orders["custkey"][urgent]
    matched_orders = int(np.isin(ocust, ccust).sum())
    lonely = int((~np.isin(ccust, ocust)).sum())
    full = [(len(ocust) + lonely, matched_orders + lonely, len(ocust),
             float(orders["totalprice"][urgent].sum()))]

    # DISTINCT (partkey, suppkey) of the 1998 lines; the UNION's custkeys
    pairs = np.unique(np.stack([li["partkey"], li["suppkey"]], axis=1)
                      [li["shipdate"] >= days("1998-01-01")], axis=0)
    distinct = [(int(a), int(b)) for a, b in pairs]
    union = [(int(k),) for k in np.union1d(
        ocust, cust["custkey"][cust["acctbal"] > 9000])]
    return {"q11": q11, "q15": q15, "q21": q21, "q22": q22,
            "q22_exists": q22_exists, "full": full, "distinct": distinct,
            "union": union}


def q19_oracle(np, gen_module, schema=Q19_SCHEMA):
    """Q19 and Q19_LIVE in numpy at `schema`: the lines of Q19's three
    brand / container / quantity / size branches, and of Q19_LIVE's two
    size / quantity and brand / shipinstruct branches, joined to their
    part by index; and the number of lineitem rows."""
    gen = gen_module.TpchGenerator(gen_module.TpchConnector.SCHEMAS[schema])
    li = table(np, gen, "lineitem", ("partkey", "quantity", "shipmode",
                                     "shipinstruct", "extendedprice",
                                     "discount"))
    part = table(np, gen, "part", ("partkey", "brand", "container",
                                   "size"))
    assert (part["partkey"] == np.arange(1, len(part["partkey"]) + 1)).all()

    def codes(tbl, col, values):
        d = gen.schema(tbl).column(col).dictionary
        return [d.index(v) for v in values if v in d]
    row = li["partkey"] - 1
    brand, cont, size = (part[c][row] for c in ("brand", "container",
                                                "size"))
    q = li["quantity"]
    common = np.isin(li["shipmode"], codes("lineitem", "shipmode",
                                           ("AIR", "AIR REG"))) \
        & np.isin(li["shipinstruct"], codes("lineitem", "shipinstruct",
                                            ("DELIVER IN PERSON",)))
    hit = np.zeros(len(q), bool)
    for b, cs, lo, hi, smax in (
            ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1,
             11, 5),
            ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10,
             20, 10),
            ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20,
             30, 15)):
        hit |= np.isin(brand, codes("part", "brand", (b,))) \
            & np.isin(cont, codes("part", "container", cs)) \
            & (q >= lo) & (q <= hi) & (size >= 1) & (size <= smax)
    hit &= common
    price = li["extendedprice"] * (1 - li["discount"])
    live = ((size >= 1) & (size <= 25) & (q <= 25)) \
        | (np.isin(brand, codes("part", "brand", ("Brand#12", "Brand#23",
                                                  "Brand#34")))
           & np.isin(li["shipinstruct"], codes("lineitem", "shipinstruct",
                                               ("DELIVER IN PERSON",))))
    return {"q19": [(float(price[hit].sum()) if hit.any() else None,)],
            "q19_live": [(float(price[live].sum()), int(live.sum()))]}, \
        len(q)


#: queries whose ORDER BY leaves ties: the number of leading columns
#: it orders by (rows tied on those may come in any order)
PARTIAL_ORDER = {"q20": 1}
#: queries with no ORDER BY: compared as multisets
UNORDERED = {"distinct", "union"}
#: queries ordered by one DOUBLE column, descending: compared as
#: multisets, and the rows must come in descending order of that column
DESC_BY = {"q11": 1}


def result_matches(label, got, want) -> bool:
    """rows_match under the query's ordering rule."""
    if label in UNORDERED:
        return rows_match(sorted(got), sorted(want))
    if label in DESC_BY:
        c = DESC_BY[label]
        return all(a[c] >= b[c] for a, b in zip(got, got[1:])) \
            and rows_match(sorted(got), sorted(want))
    return rows_match(got, want, PARTIAL_ORDER.get(label))


def rows_match(got, want, order_cols=None) -> bool:
    """The repository's TPC-H rule: floats to rel 1e-6, the rest
    exactly, in order; with `order_cols`, in order on those leading
    columns only, and as a multiset otherwise."""
    import math
    if order_cols is not None:
        return [g[:order_cols] for g in got] \
            == [w[:order_cols] for w in want] \
            and rows_match(sorted(got), sorted(want))
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for gv, wv in zip(g, w):
            if isinstance(gv, float) or isinstance(wv, float):
                if not math.isclose(gv, wv, rel_tol=1e-6, abs_tol=1e-6):
                    return False
            elif gv != wv:
                return False
    return True


# -- capture of the main path's kernel inputs --------------------------

def tensors_of(obj):
    """Every tensor inside `obj` (tensors, batches, columns, states,
    sequences and dicts of them)."""
    import dataclasses
    import torch
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from tensors_of(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from tensors_of(x)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors_of(getattr(obj, f.name))


def rows_of(*objs) -> int:
    """The largest first dimension among the tensors of `objs`."""
    return max((t.shape[0] for o in objs for t in tensors_of(o)
                if t.dim()), default=0)


#: the aggregation state's calls on the main path (hashagg_merge,
#: agg_shrink, agg_count, agg_finalize), each captured at its largest
#: call and held against its plain version there: label -> (family,
#: module key, function name)
AGG_CALLS = {
    "hashagg_merge merge_states": ("hashagg_merge", "agg", "merge_states"),
    "agg_shrink _shrink_state": ("agg_shrink", "agg", "_shrink_state"),
    "agg_count _count_live": ("agg_count", "agg", "_count_live"),
    "agg_finalize finalize": ("agg_finalize", "th", "finalize"),
    "agg_finalize direct_finalize": ("agg_finalize", "th",
                                     "direct_finalize"),
}


class Patches:
    """Wrappers set on module attributes for the length of a `with`
    block, restored in reverse order on its exit."""

    def __init__(self):
        self._patches = []

    def _patch(self, mod, attr, make):
        orig = getattr(mod, attr)
        self._patches.append((mod, attr, orig))
        setattr(mod, attr, make(orig))

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._patches):
            setattr(mod, attr, orig)
        self._patches = []
        return False


class Capture(Patches):
    """Wraps the kernel wrappers (and the aggregation state's calls of
    AGG_CALLS) during one run of the queries and keeps the inputs of each
    one's largest call: a copy for K1 and K2 (K1 updates its state in
    place), references for the rest (their inputs are not written after
    the call). K12 records its own largest call per generated kernel
    (`codegen.CAPTURE`), with the query that made it (`k12_query`)."""

    def __init__(self, mods):
        super().__init__()
        self.m = mods
        self.k1 = {}   # query -> (rows, args)
        self.k2 = {}   # query -> (rows, batch, out_cap)
        self.big = {}  # kernel -> (rows, query, args)
        #: K9 per layout: (output slots, query, args) of its largest
        #: call, and calls per (query, layout)
        self.expand = {}
        self.expand_calls = {}
        #: K9 in full mode at its largest call: (output slots, query,
        #: args, the matched flags as they were before the call)
        self.expand_full = None
        #: K10 per query: (output slots, (probe, build, out_cap))
        self.k10 = {}
        #: K11 at its largest call: (rows, query, args)
        self.k11 = None
        #: the DISTINCT fold at its largest call: (rows, query, args)
        self.distinct = None
        #: K22 at its largest call without overflow: (rows, query, args)
        self.df_set_fits = None
        #: K25 at its largest join build: (rows, query, args, kwargs)
        self.build_sort = None
        #: AGG_CALLS label -> (rows, query, function, args)
        self.composed = {}
        #: K12 kernel fingerprint -> the query of its largest call
        self.k12_query = {}
        self.query = None

    def run(self, label, fn):
        """Run one query under capture as `label`."""
        cg = self.m["codegen"]
        self.query = label
        before = {fp: id(v[2]) for fp, v in cg.CAPTURE.items()}
        fn()
        for fp, v in cg.CAPTURE.items():
            if before.get(fp) != id(v[2]):
                self.k12_query[fp] = label

    def _keep(self, kernel, rows, args):
        if rows > self.big.get(kernel, (0,))[0]:
            self.big[kernel] = (rows, self.query, args)

    def _record(self, label):
        def make(orig):
            def wrapper(*args):
                # a merge by the rows of all its states
                rows = sum(rows_of(st) for st in args[0]) \
                    if label.startswith("hashagg_merge") else rows_of(*args)
                if rows > self.composed.get(label, (0,))[0]:
                    self.composed[label] = (rows, self.query, orig, args)
                return orig(*args)
            return wrapper
        return make

    def __enter__(self):
        m = self.m
        tb, th, tc, tj = m["tb"], m["th"], m["tc"], m["tj"]

        def slot_reduce(orig):
            def rec(row_valid, keys, domains, comps, present):
                n = row_valid.shape[0]
                if n > self.k1.get(self.query, (0,))[0]:
                    self.k1[self.query] = (n, (
                        row_valid.clone(),
                        [(c.clone(), mm.clone()) for c, mm in keys],
                        domains,
                        [(c.clone(), st.clone(), r) for c, st, r in comps],
                        present.clone()))
                return orig(row_valid, keys, domains, comps, present)
            return rec

        def shrink(orig):
            def rec(batch, capacity):
                if batch.capacity > self.k2.get(self.query, (0,))[0]:
                    copy = tb.Batch({n: tb.Column(c.data.clone(),
                                                  c.mask.clone(), c.type,
                                                  c.dictionary)
                                     for n, c in batch.columns.items()},
                                    batch.row_valid.clone())
                    self.k2[self.query] = (batch.capacity, copy, capacity)
                return orig(batch, capacity)
            return rec

        def keep(kernel, rows_fn):
            def make(orig):
                def rec(*args):
                    self._keep(kernel, rows_fn(*args), args)
                    return orig(*args)
                return rec
            return make

        def expand(orig):
            def rec(table, probe, *args):
                out_capacity = args[2]
                if args[3] == "full":
                    # the full mode, apart from the inner/left layouts
                    if out_capacity > (self.expand_full or (0,))[0]:
                        self.expand_full = (out_capacity, self.query,
                                            (table, probe, *args[:-1]),
                                            args[-1].clone())
                    return orig(table, probe, *args)
                layout = "aligned" if tj._aligned_layout(
                    table, probe, out_capacity, args[3]) else "general"
                key = (self.query, layout)
                self.expand_calls[key] = self.expand_calls.get(key, 0) + 1
                if out_capacity > self.expand.get(layout, (0,))[0]:
                    self.expand[layout] = (out_capacity, self.query,
                                           (table, probe, *args))
                return orig(table, probe, *args)
            return rec

        self._patch(th, "direct_slot_reduce", slot_reduce)
        self._patch(tb, "compact_shrink", shrink)
        self._patch(tc, "row_hash_pair", keep(
            "row_hash", lambda keys, rv, ni: rv.shape[0]))
        self._patch(tj, "build_meta", keep(
            "join_build", lambda sh, k: sh.shape[0]))
        self._patch(tj, "probe_search", keep(
            "join_probe", lambda table, probe, *a: probe.capacity))
        self._patch(th, "segment_reduce", keep(
            "segment_reduce", lambda h1, *a: h1.shape[0]))
        # K7 at its largest probe + build; K8 at its largest batch
        self._patch(tj, "semi_mark", keep(
            "semi_join", lambda table, probe, *a:
            probe.capacity + table.sorted_hash.shape[0]))
        self._patch(th, "stream_step", keep(
            "stream_reduce", lambda carry, rv, *a: rv.shape[0]))
        self._patch(tj, "_expand_from_enc", expand)
        # K21 and K22 at their largest key column; K23 at its largest
        # probe batch, one with a set before any without
        df = m["df"]
        self._patch(df, "bounds_step", keep(
            "df_bounds", lambda state, data, mask: data.shape[0]))
        def distinct_set(orig):
            def rec(data, mask):
                self._keep("df_distinct_set", data.shape[0], (data, mask))
                out = orig(data, mask)
                # the largest call whose set fits (its values are
                # compared too); one host read per call, capture only
                if not bool(out[2]) and data.shape[0] > (
                        self.df_set_fits or (0,))[0]:
                    self.df_set_fits = (data.shape[0], self.query,
                                        (data, mask))
                return out
            return rec
        self._patch(df, "distinct_set", distinct_set)
        self._patch(df, "apply_filter", keep(
            "df_apply", lambda batch, col, mn, mx, has_set, *a:
            batch.capacity * (2 if has_set else 1)))

        def cross(orig):
            def rec(probe, build, np_rows, nb, out_cap):
                args = (probe, build, np_rows, nb, out_cap)
                if out_cap > self.k10.get(self.query, (0,))[0]:
                    self.k10[self.query] = (out_cap, args)
                return orig(*args)
            return rec

        def outer(orig):
            def rec(table, matched, *args):
                if table.batch.capacity > (self.k11 or (0,))[0]:
                    self.k11 = (table.batch.capacity, self.query,
                                (table, matched.clone(), *args))
                return orig(table, matched, *args)
            return rec

        def distinct(orig):
            def rec(state, batch):
                rows = state.capacity + batch.capacity
                if rows > (self.distinct or (0,))[0]:
                    self.distinct = (rows, self.query, (state, batch))
                return orig(state, batch)
            return rec
        def radix(orig):
            def rec(*args, **kw):
                # the join build's sort is the one that returns the
                # sorted hashes
                rows = tc._word_list(args[0])[0].shape[0]
                if kw.get("sorted_first") and rows > (
                        self.build_sort or (0,))[0]:
                    self.build_sort = (rows, self.query, args, kw)
                return orig(*args, **kw)
            return rec
        self._patch(tc, "radix_sort", radix)
        self._patch(m["misc"], "cross_product", cross)
        self._patch(tj, "unmatched_build", outer)
        self._patch(m["sort"], "distinct_step", distinct)
        for label, (_, mod, fn) in AGG_CALLS.items():
            self._patch(m[mod], fn, self._record(label))
        m["codegen"].CAPTURE = {}
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.k12 = self.m["codegen"].CAPTURE
        self.m["codegen"].CAPTURE = None
        return False


# -- phases ------------------------------------------------------------------

def profile_query(torch, gen_module, runner, sql, gen_cls=None, read=None):
    """One warm execution under torch.profiler: wall time, the host
    seconds spent generating data (tpch's generator, or `gen_cls`'s; in
    all, and per table: calls, seconds, the slowest call, rows), device
    busy time (the sum of the kernels' self device time) and the kernels
    that took most of it. `device_busy_ms` is None when the profiler
    recorded no device time. `read` reads the result (`rows()` unless
    given)."""
    from torch.profiler import ProfilerActivity, profile
    gen_cls = gen_cls or gen_module.TpchGenerator
    orig = gen_cls.generate
    datagen = [0.0]
    by_table = {}

    def timed_generate(self, table, *args, **kwargs):
        t = time.perf_counter()
        out = None
        try:
            out = orig(self, table, *args, **kwargs)
            return out
        finally:
            dt = time.perf_counter() - t
            datagen[0] += dt
            calls, secs, slowest, rows = by_table.get(table, (0, 0.0, 0.0, 0))
            data = out[0] if isinstance(out, tuple) else out
            n = len(next(iter(data.values()))) if data else 0
            by_table[table] = (calls + 1, secs + dt, max(slowest, dt),
                               rows + n)
    gen_cls.generate = timed_generate
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            res = runner.execute(sql)
            res.rows() if read is None else read(res)
            wall = time.perf_counter() - t
    finally:
        gen_cls.generate = orig

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, copies): the host ops that
    # launched them report the same device time again
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:6]
    # kernel launches: every device event that is not a copy or a fill
    launched = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.key.lower().startswith(("memcpy", "memset"))]
    return {"wall_s": wall, "datagen_s": datagen[0],
            "cuda_kernel_launches": sum(e.count for e in launched),
            "datagen_by_table": {
                t: {"calls": c, "s": sec, "slowest_s": mx, "rows": r}
                for t, (c, sec, mx, r) in sorted(by_table.items())},
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "device_idle_share": 1 - busy_us / 1e6 / wall
            if busy_us else None,
            "top_device_ms": {e.key[:80]: dev_us(e) / 1e3 for e in top}}


def measure_k1(torch, th, args, label):
    row_valid, keys, domains, comps, present = args

    def fresh():
        return ([(c, s.clone(), r) for c, s, r in comps], present.clone())

    kc, kp = fresh()
    th.direct_slot_reduce(row_valid, keys, domains, kc, kp)
    pc, pp = fresh()
    th.slot_reduce_plain(row_valid, keys, domains, pc, pp)
    torch.cuda.synchronize()
    check(torch.equal(kp, pp), f"K1 {label}: present flags differ")
    max_abs, max_rel = 0.0, 0.0
    for (_, ks, _), (_, ps, _) in zip(kc, pc):
        if ks.is_floating_point():
            diff = (ks - ps).abs()
            max_abs = max(max_abs, float(diff.max()))
            rel = diff / ps.abs().clamp(min=1e-300)
            max_rel = max(max_rel, float(rel.max()))
            check(bool(torch.allclose(ks, ps, rtol=1e-9, atol=0)),
                  f"K1 {label}: float component differs beyond rel 1e-9")
        else:
            check(torch.equal(ks, ps), f"K1 {label}: integer component "
                  "differs")
    tc, tp = fresh()
    ms = time_ms(lambda: th.direct_slot_reduce(row_valid, keys, domains,
                                               tc, tp), torch)
    plain_ms = time_ms(lambda: th.slot_reduce_plain(row_valid, keys,
                                                    domains, tc, tp),
                       torch)
    num_slots = present.shape[0]
    gid = th.slot_ids(row_valid, keys, domains, num_slots)
    tables = [torch.zeros(num_slots + 1, dtype=s.dtype, device=s.device)
              for _, s, _ in comps]

    def library():
        for (c, _, r), t in zip(comps, tables):
            if r == "sum":
                t.index_add_(0, gid, c)
            else:
                t.scatter_reduce_(0, gid, c, reduce="a" + r)
    library_ms = time_ms(library, torch)
    # bytes this data needs: row_valid of every row, keys and
    # contributions of the live rows only, the state read and written
    live = int(row_valid.sum())
    per_live_row = sum(c.element_size() + m.element_size()
                       for c, m in keys) \
        + sum(c.element_size() for c, _, _ in comps)
    moved = nbytes(row_valid) + live * per_live_row \
        + 2 * nbytes(*[s for _, s, _ in comps]) + nbytes(present)
    return {"rows": int(row_valid.shape[0]), "live": live,
            "slots": int(num_slots),
            "components": len(comps), "max_abs_err": max_abs,
            "max_rel_err": max_rel, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_k2(torch, tb, batch, out_cap, label):
    if out_cap < batch.capacity:
        kern = lambda: tb.compact_shrink(batch, out_cap)  # noqa: E731
        plain = lambda: tb.compact_shrink_plain(batch, out_cap)  # noqa
        written = out_cap
    else:
        kern = lambda: tb.compact_full(batch)  # noqa: E731
        plain = lambda: tb.compact_full_plain(batch)  # noqa: E731
        written = batch.capacity
    got, want = kern(), plain()
    torch.cuda.synchronize()
    check(torch.equal(got.row_valid, want.row_valid),
          f"K2 {label}: row_valid differs")
    for n in want.names:
        check(torch.equal(got.columns[n].data, want.columns[n].data)
              and torch.equal(got.columns[n].mask, want.columns[n].mask),
              f"K2 {label}: column {n} differs")
    ms = time_ms(kern, torch)
    plain_ms = time_ms(plain, torch)
    rv = batch.row_valid

    def library():
        for c in batch.columns.values():
            c.data[rv]
            c.mask[rv]
    library_ms = time_ms(library, torch)
    cols = list(batch.columns.values())
    # bytes this data needs: row_valid of every row; the shrink reads
    # only the live rows (and the one fill row), the full variant every
    # row; each output row written once (data, mask, row_valid)
    live = int(rv.sum())
    row_bytes = sum(c.data.element_size() + 1 for c in cols)
    read_rows = min(live, written) + 1 if written < batch.capacity \
        else batch.capacity
    moved = nbytes(rv) + read_rows * row_bytes + written * (row_bytes + 1)
    return {"rows": batch.capacity, "out_rows": written,
            "live": live, "columns": len(cols),
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def key_bytes(keys, rows) -> int:
    return rows * sum(d.element_size() + m.element_size() for d, m in keys)


def measure_k3(torch, tc, args):
    keys, row_valid, nulls_invalid = args
    got = tc.row_hash_pair(keys, row_valid, nulls_invalid)
    want = tc.row_hash_pair_plain(keys, row_valid, nulls_invalid)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "K3 row_hash differs from its plain version")
    n = row_valid.shape[0]
    ms = time_ms(lambda: tc.row_hash_pair(keys, row_valid,
                                          nulls_invalid), torch)
    plain_ms = time_ms(lambda: tc.row_hash_pair_plain(
        keys, row_valid, nulls_invalid), torch)
    # keys, masks and row_valid read once; two int64 hashes written
    moved = key_bytes(keys, n) + nbytes(row_valid) + 16 * n
    return {"rows": n, "keys": len(keys), "nulls_invalid": nulls_invalid,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_k4(torch, tj, args):
    sh, k = args
    got = tj.build_meta(sh, k)
    want = tj.build_meta_plain(sh, k)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "K4 join_build differs from its plain version")
    n = sh.shape[0]
    ms = time_ms(lambda: tj.build_meta(sh, k), torch)
    plain_ms = time_ms(lambda: tj.build_meta_plain(sh, k), torch)
    library_ms = None
    if k > 0:
        library_ms = time_ms(lambda: torch.cumsum(torch.bincount(
            tj._partition_of(sh, k), minlength=1 << k), 0), torch)
    shuffled = sh[torch.randperm(n, device=sh.device)]
    sort_ms = time_ms(lambda: torch.sort(shuffled, stable=True), torch)
    # sorted hashes read once; run lengths, bucket offsets and the
    # three statistics written once
    moved = 16 * n + 8 * got[0].shape[0] + 24
    stats = [int(x) for x in got[2].tolist()]
    return {"rows": n, "live": stats[0], "radix_bits": k,
            "max_span": stats[1], "max_run": stats[2],
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "torch_sort_ms": sort_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_k5(torch, tc, tj, args):
    table, probe, names, verify = args
    got = tj.probe_search(table, probe, names, verify)
    want = tj.probe_search_plain(table, probe, names, verify)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]),
          "K5 join_probe lo_enc differs from its plain version")
    # hash2 is returned only where the search did not check it itself
    checks_h2 = table.unique_runs and verify == "hash"
    check((got[1] is None) == (want[1] is None) == checks_h2
          and (got[1] is None or torch.equal(got[1], want[1])),
          "K5 join_probe h2 differs from its plain version")
    n = probe.capacity
    ms = time_ms(lambda: tj.probe_search(table, probe, names, verify),
                 torch)
    plain_ms = time_ms(lambda: tj.probe_search_plain(table, probe, names,
                                                     verify), torch)
    h, _ = tc.row_hash_pair([probe.columns[k].astuple() for k in names],
                            probe.row_valid, True)
    library_ms = time_ms(lambda: torch.searchsorted(table.sorted_hash, h),
                         torch)
    keys = [probe.columns[k].astuple() for k in names]
    # probe keys, masks and row_valid read once; the build's sorted
    # hashes and bucket offsets read once, its second hashes only where
    # the search checks them; lo_enc written once, and the probe's
    # hash2 only where the expand needs it (the search did not check it)
    moved = key_bytes(keys, n) + nbytes(probe.row_valid) \
        + nbytes(table.sorted_hash, table.part_starts) \
        + (nbytes(table.hash2) if checks_h2 else 8 * n) + 8 * n
    return {"probe_rows": n, "build_rows": int(table.sorted_hash.shape[0]),
            "radix_bits": table.radix_bits,
            "unique_runs": table.unique_runs, "verify": verify,
            "matches": int((got[0] >= 0).sum()),
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_k6(torch, tc, th, args):
    # (the main path's call also passes the list K6's segments go to)
    args = args[:6]
    h1, h2, keys, valid, comps, out_cap = args
    got = th.segment_reduce(*args)
    want = th.segment_reduce_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got[1:], want[1:]):
        check(torch.equal(g, w), "K6 segment_reduce: first rows, group "
              "count or overflow differ from its plain version")
    max_abs = 0.0
    for g, w in zip(got[0], want[0]):
        if g.is_floating_point():
            live = torch.arange(out_cap, device=g.device) < want[2]
            diff = (g - w).abs()[live]
            if diff.numel():
                max_abs = max(max_abs, float(diff.max()))
            check(bool(torch.allclose(g, w, rtol=1e-9, atol=0)),
                  "K6 float component differs beyond rel 1e-9")
        else:
            check(torch.equal(g, w), "K6 integer component differs")
    ms = time_ms(lambda: th.segment_reduce(*args), torch)
    plain_ms = time_ms(lambda: th.segment_reduce_plain(*args), torch)
    _, gid, _ = th.segment_ids(h1, h2, keys, valid, out_cap)

    def library():
        for c, r in comps:
            red = torch.zeros(out_cap + 1, dtype=c.dtype, device=c.device)
            red.scatter_reduce_(0, gid, c, {"sum": "sum", "min": "amin",
                                            "max": "amax"}[r])
    library_ms = time_ms(library, torch)
    n = valid.shape[0]
    perm = torch.randperm(n, device=h1.device)
    s1, s2 = h1[perm], h2[perm]
    k25_ms = time_ms(lambda: tc.lex_perm([s1, s2]), torch)
    # sorted hashes, keys, row_valid and contributions read once; the
    # first rows and out_cap slots per component written once (the
    # caller reads no per-row group id)
    moved = nbytes(h1, h2, valid) + key_bytes(keys, n) \
        + nbytes(*[c for c, _ in comps]) + 8 * out_cap \
        + out_cap * sum(c.element_size() for c, _ in comps)
    return {"rows": n, "live": int(valid.sum()), "groups": int(want[2]),
            "out_cap": out_cap, "keys": len(keys),
            "components": len(comps), "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "k25_sort_ms": k25_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_k7(torch, tj, args):
    table, probe, names, build_keys, verify, negate = args
    got = tj.semi_mark(*args)
    want = tj.semi_mark_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          "K7 semi_join keep mask differs from its plain version")
    n = probe.capacity
    ms = time_ms(lambda: tj.semi_mark(*args), torch)
    plain_ms = time_ms(lambda: tj.semi_mark_plain(*args), torch)
    keys = [probe.columns[k].astuple() for k in names]
    bkeys = [table.batch.columns[k].astuple() for k in build_keys]
    library_ms = None
    if len(keys) == 1:
        # one call computing the same membership (NULLs aside)
        live = table.batch.row_valid & bkeys[0][1]
        bvals = bkeys[0][0][live]
        library_ms = time_ms(lambda: torch.isin(keys[0][0], bvals), torch)
    mode = tj._semi_mode(table, verify)
    walked = mode != tj._SEMI_UNIQUE_HASH
    build = [table.sorted_hash, table.hash2] \
        + ([table.run_len] if walked else [])
    # probe keys, masks and row_valid read once; of the build, every
    # array once or, when the probe is smaller, per probe row its
    # bucket bounds and one entry of each array (and the key columns of
    # one row under verify="full"), whichever is less; the keep mask
    # written once
    nb = table.sorted_hash.shape[0]
    per_row = 16 + 8 * len(build) + (key_bytes(bkeys, 1)
                                     if mode == tj._SEMI_WALK_FULL else 0)
    whole = nbytes(table.part_starts, *build) \
        + (key_bytes(bkeys, nb) if mode == tj._SEMI_WALK_FULL else 0)
    moved = key_bytes(keys, n) + nbytes(probe.row_valid) \
        + min(whole, n * per_row) + n
    return {"probe_rows": n, "build_rows": int(table.sorted_hash.shape[0]),
            "radix_bits": table.radix_bits,
            "unique_runs": table.unique_runs, "verify": verify,
            "negate": negate, "kept": int(want.sum()),
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_k8(torch, th, args):
    carry, rv, keys, contribs, aggs, out_cap = args
    got = th.stream_step(*args)
    want = th.stream_fold_plain(
        carry, th.presorted_reduce_plain(rv, keys, contribs, aggs, out_cap),
        aggs)
    torch.cuda.synchronize()
    (g_ce, g_em, g_co, g_last), (w_ce, w_em, w_co, w_last) = got, want
    live = w_em.valid
    check(torch.equal(g_ce.valid, w_ce.valid)
          and torch.equal(g_em.valid, live)
          and int(g_last) == int(w_last)
          and torch.equal(g_co.valid, w_co.valid)
          and all(torch.equal(gd[live], wd[live])
                  and torch.equal(gm[live], wm[live])
                  for (gd, gm), (wd, wm) in zip(g_em.keys, w_em.keys))
          and all(torch.equal(gd, wd) and torch.equal(gm, wm)
                  for (gd, gm), (wd, wm) in zip(g_co.keys, w_co.keys)),
          "K8 stream_reduce: groups, keys or carry differ from its plain "
          "version")
    max_abs = 0.0
    for gs, ws, gc, wc in zip(g_em.states, w_em.states, g_co.states,
                              w_co.states):
        for g, w, cg, cw in zip(gs, ws, gc, wc):
            if g.is_floating_point():
                diff = (g[live] - w[live]).abs()
                if diff.numel():
                    max_abs = max(max_abs, float(diff.max()))
                check(bool(torch.allclose(g[live], w[live], rtol=1e-9,
                                          atol=0))
                      and bool(torch.allclose(cg, cw, rtol=1e-9, atol=0)),
                      "K8 float component differs beyond rel 1e-9")
            else:
                check(torch.equal(g[live], w[live]) and torch.equal(cg, cw),
                      "K8 integer component differs")
    ms = time_ms(lambda: th.stream_step(*args), torch)
    plain_ms = time_ms(lambda: th.stream_fold_plain(
        carry, th.presorted_reduce_plain(rv, keys, contribs, aggs, out_cap),
        aggs), torch)
    comps = [(a, r) for st, agg in zip(contribs, aggs)
             for a, r in zip(st, agg.reduces)]
    # the library yardstick: scatter_reduce per component over the
    # group ids (computed outside the timing)
    _, gid, _ = th.presorted_ids(rv, keys, out_cap)

    def library():
        for c, r in comps:
            red = torch.zeros(out_cap + 1, dtype=c.dtype, device=c.device)
            red.scatter_reduce_(0, gid, c, {"sum": "sum", "min": "amin",
                                            "max": "amax"}[r])
    library_ms = time_ms(library, torch)
    n = rv.shape[0]
    # keys, row_valid and contributions read once; out_cap slots per
    # component, the first rows and the slot validity written once
    moved = key_bytes(keys, n) + nbytes(rv) + nbytes(*[c for c, _ in comps]) \
        + out_cap * (sum(c.element_size() for c, _ in comps) + 8 + 1)
    return {"rows": n, "live": int(rv.sum()),
            "groups": int(w_last) + 1, "out_cap": out_cap,
            "keys": len(keys), "components": len(comps),
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_k9(torch, tj, args, calls, matched=None):
    """K9 at its largest call of one layout (in full mode with the
    call's `matched` flags) against the plain version (the composed
    torch expand), and its calls per query."""
    (table, probe, names, lo_enc, cap, join_type, probe_out, build_out,
     build_keys, verify, h2) = args
    flags = [None if matched is None else matched.clone()
             for _ in range(3)]
    got = tj._expand_from_enc(*args, flags[0])
    want = tj.expand_plain(*args, flags[1])
    torch.cuda.synchronize()
    (gb, govf, glive), (wb, wovf, wlive) = got, want
    check(bool(govf) == bool(wovf) and int(glive) == int(wlive)
          and torch.equal(gb.row_valid, wb.row_valid)
          and (matched is None or torch.equal(flags[0], flags[1])),
          "K9 join_expand: liveness, overflow, live count or matched flags "
          "differ from its plain version")
    for nm in (*probe_out, *build_out):
        g, w = gb.columns[nm], wb.columns[nm]
        check(torch.equal(g.mask, w.mask)
              and torch.equal(g.data[w.mask], w.data[w.mask]),
              f"K9 join_expand: column {nm} differs from its plain version")
    ms = time_ms(lambda: tj._expand_from_enc(*args, flags[2]), torch)
    plain_ms = time_ms(lambda: tj.expand_plain(*args, flags[2]), torch)
    n = probe.capacity
    out_rows = gb.row_valid.shape[0]
    aligned = tj._aligned_layout(table, probe, cap, join_type)
    pcols = [probe.columns[c] for c in probe_out]
    bcols = [table.batch.columns[c] for c in build_out]
    if aligned:
        # lo_enc, row_valid, the probe masks and each build column's
        # gathered rows read once; liveness, the probe masks and the
        # build columns written once (probe data passes through)
        moved = 9 * n + 2 * n * len(pcols) \
            + 2 * n * sum(c.data.element_size() + 1 for c in bcols) + n
    else:
        found = lo_enc >= 0
        slots = min(out_rows, int(torch.where(
            found, table.run_len[lo_enc.clamp(min=0)],
            torch.zeros_like(lo_enc)).sum()))
        # per probe row lo_enc, row_valid, its run length and hash2;
        # per filled slot the build row's columns (and hash2) read; the
        # probe columns read once; every output slot written once
        moved = 25 * n + (8 * slots if h2 is not None else 0) \
            + sum(c.data.element_size() + 1 for c in pcols) * (n + out_rows) \
            + sum(c.data.element_size() + 1 for c in bcols) \
            * (slots + out_rows) + out_rows
    if matched is not None:
        # the flags of the matched build rows written once
        moved += int(flags[1].sum())
    return {"layout": ("full " if matched is not None else "")
            + ("aligned" if aligned else "general"),
            "probe_rows": n, "out_capacity": out_rows,
            "build_rows": int(table.sorted_hash.shape[0]),
            "join_type": join_type, "verify": verify,
            "live": int(wlive), "overflow": bool(wovf),
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "calls": calls,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def state_arrays(st):
    """Every array of a sort-path state, keys' data and masks first."""
    return [a for d, m in st.keys for a in (d, m)] \
        + [a for t in st.states for a in t] + [st.valid]


def float_err(torch, got, want, rtol, what) -> float:
    """The largest absolute difference of two float tensors (NaN equal to
    NaN); fails unless every value is within `rtol` of the wanted one
    (0: equal)."""
    if not got.numel():
        return 0.0
    both_nan = torch.isnan(got) & torch.isnan(want)
    d = torch.where(both_nan, torch.zeros_like(got), (got - want).abs())
    check(bool((d <= rtol * want.abs()).all()),
          f"{what}: float values differ from the plain version beyond "
          f"rel {rtol}")
    return float(d.max())


def state_err(torch, got, want, what, rtol) -> float:
    """Check two sort-path states hold the same groups (valid, live
    count, keys and integer components exactly, float components within
    `rtol`); the largest absolute difference of their float components
    over the live groups."""
    live = want.valid
    check(torch.equal(got.valid, live) and int(got.live) == int(want.live)
          and bool(got.overflow) == bool(want.overflow),
          f"{what}: groups or live count differ from the plain version")
    err = 0.0
    for g, w in zip(state_arrays(got)[:-1], state_arrays(want)[:-1]):
        gl, wl = g[live], w[live]
        if g.is_floating_point():
            err = max(err, float_err(torch, gl, wl, rtol, what))
        else:
            check(torch.equal(gl, wl),
                  f"{what}: an integer array differs from the plain version")
    return err


def batch_err(torch, got, want, what, rtol) -> float:
    """Check two output batches have the same capacity, liveness, masks
    and integer values under the masks, and float values within `rtol`;
    the largest absolute difference of their float values under the
    masks."""
    check(got.capacity == want.capacity
          and torch.equal(got.row_valid, want.row_valid)
          and list(got.columns) == list(want.columns),
          f"{what}: rows or columns differ from the plain version")
    err = 0.0
    for name, w in want.columns.items():
        g = got.columns[name]
        check(g.data.dtype == w.data.dtype and torch.equal(g.mask, w.mask),
              f"{what}: column {name}'s type or mask differs")
        gd, wd = g.data[w.mask], w.data[w.mask]
        if gd.is_floating_point():
            err = max(err, float_err(torch, gd, wd, rtol,
                                     f"{what}: column {name}"))
        else:
            check(torch.equal(gd, wd),
                  f"{what}: column {name} differs from the plain version")
    return err


def _moved(inputs, out) -> int:
    """Bytes of every input tensor read once and every output tensor that
    is not an input written once."""
    seen = {t.data_ptr(): nbytes(t) for t in tensors_of(inputs)}
    moved = sum(seen.values())
    for t in tensors_of(out):
        if t.data_ptr() not in seen:
            seen[t.data_ptr()] = 0
            moved += nbytes(t)
    return moved


def _bound(moved) -> float:
    return moved / HBM_BYTES_PER_S * 1e3


def measure_merge(torch, tc, th, args):
    """hashagg_merge at its largest call: merge_partials (K3 and K26 over
    the states as sources, K25, K6, K30) against the plain composition
    (which concatenates), and K3 and K26 over the sources alone against
    their plain versions. Returns (merge, K3, K26) measurements."""
    states, aggs, out_cap = list(args[0]), args[1], args[2]
    got = th.merge_partials(states, aggs, out_cap)
    want = th.merge_partials(states, aggs, out_cap, plain=True)
    torch.cuda.synchronize()
    # K6 adds each group's floats in a tree, the plain version in row
    # order: the sums may differ in the last bits
    err = state_err(torch, got, want, "merge_states", MERGE_RTOL)
    n = sum(st.valid.shape[0] for st in states)
    merge = {"rows": n, "sources": len(states), "max_abs_err": err,
             "ms": time_ms(lambda: th.merge_partials(states, aggs, out_cap),
                           torch),
             "plain_ms": time_ms(lambda: th.merge_partials(
                 states, aggs, out_cap, plain=True), torch),
             "library_ms": None, "bound_ms": _bound(_moved(states, got))}
    parts = [([(d.contiguous(), m.contiguous()) for d, m in st.keys],
              st.valid.contiguous()) for st in states]
    h = tc.row_hash_sources(parts, False)
    hp = tc.row_hash_sources_plain(parts, False)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(h, hp)),
          "K3 over the merge's sources differs from its plain version")
    keys_bytes = sum(key_bytes(k, v.shape[0]) + nbytes(v) for k, v in parts)
    k3 = {"rows": n, "sources": len(states), "max_abs_err": 0.0,
          "ms": time_ms(lambda: tc.row_hash_sources(parts, False), torch),
          "plain_ms": time_ms(lambda: tc.row_hash_sources_plain(parts,
                                                                False),
                              torch),
          "library_ms": None, "bound_ms": _bound(keys_bytes + 16 * n)}
    perm = tc.lex_perm(list(h))
    cols, lo = [], 0
    for (keys, valid), st in zip(parts, states):
        hi = lo + valid.shape[0]
        flat = [a for t in st.states for a in t if a.dim() == 1]
        cols.append((keys + [(a, None) for a in flat]
                     + [(h[0][lo:hi], None), (h[1][lo:hi], None)], valid))
        lo = hi
    g26 = tc.gather_rows(cols, perm)
    w26 = tc.gather_rows_plain(cols, perm)
    torch.cuda.synchronize()
    check(torch.equal(g26[1], w26[1])
          and all(torch.equal(a, b) and (am is None or torch.equal(am, bm))
                  for (a, am), (b, bm) in zip(g26[0], w26[0])),
          "K26 over the merge's sources differs from its plain version")
    # every array element read once and written once, the permutation
    # and row_valid read once
    elem = sum(nbytes(d) + (0 if m is None else nbytes(m))
               for c, _ in cols for d, m in c)
    k26 = {"rows": n, "sources": len(states), "arrays": len(cols[0][0]),
           "max_abs_err": 0.0,
           "ms": time_ms(lambda: tc.gather_rows(cols, perm), torch),
           "plain_ms": time_ms(lambda: tc.gather_rows_plain(cols, perm),
                               torch),
           "library_ms": None,
           "bound_ms": _bound(2 * elem + nbytes(perm) + 2 * n)}
    return merge, k3, k26


def measure_k28(torch, ak, tagg, args):
    """K28 at the largest shrink: the copy into new storage against the
    plain copy; each shrunk array owns storage of its size (C10)."""
    st, cap = args
    got = tagg._shrink_state(st, cap)
    flat = state_arrays(st)
    want = ak.shrink_arrays_plain(flat, cap)
    torch.cuda.synchronize()
    for g, w in zip(state_arrays(got), want):
        check(torch.equal(g, w) and g.untyped_storage().nbytes() == nbytes(g),
              "K28 state_shrink differs from its plain copy or keeps "
              "storage beyond its rows")
    prefix = sum(nbytes(w) for w in want)
    return {"rows": st.valid.shape[0], "cap": cap, "arrays": len(flat),
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: tagg._shrink_state(st, cap), torch),
            "plain_ms": time_ms(lambda: ak.shrink_arrays_plain(flat, cap),
                                torch),
            "library_ms": None, "bound_ms": _bound(2 * prefix)}


def measure_count(torch, tagg, pages, args):
    """agg_count at its largest state: the carried count's copy to the
    host (no reduction) against the plain sum and its copy, and one
    count_nonzero."""
    st, = args
    got = tagg._count_live(st).get()
    check(got == int(tagg.count_live_plain(st.valid)),
          "agg_count: the carried count differs from the plain sum")
    return {"rows": st.valid.shape[0], "live": got, "max_abs_err": 0.0,
            "ms": time_ms(lambda: tagg._count_live(st), torch),
            "plain_ms": time_ms(lambda: pages.PendingScalar(
                tagg.count_live_plain(st.valid)), torch),
            "library_ms": time_ms(lambda: torch.count_nonzero(st.valid),
                                  torch),
            "bound_ms": _bound(nbytes(st.valid))}


def k29_moved(cols, rows, cap, rv) -> int:
    """Bytes one K29 launch must move for its descriptor columns: the
    first `rows` rows of every state array and auxiliary array a column
    reads (each once, however many columns read it), the row validity,
    and every output data and mask written at `cap` rows. A key or state
    array that a column aliases is not in the table and moves nothing."""
    read = {}
    for c in cols:
        for t in c.states + ([] if c.aux is None else [c.aux]):
            n = min(t.shape[0], rows)
            read[t.data_ptr()] = nbytes(t) // max(t.shape[0], 1) * n
    written = sum(nbytes(c.out) + (0 if c.out_mask is None
                                   else nbytes(c.out_mask)) for c in cols)
    return sum(read.values()) + (0 if rv is None else rows) + written


def measure_k29(torch, th, name, args):
    """K29 at `name`'s largest drain against the composed drain; its
    bound from the descriptor columns of that launch."""
    fn, plain = getattr(th, name), getattr(th, name + "_plain")
    launches = []
    real = th.ak.finalize_columns

    def record(cols, rows, cap, rv):
        launches.append(k29_moved(cols, rows, cap, rv))
        return real(cols, rows, cap, rv)
    th.ak.finalize_columns = record
    try:
        got = fn(*args)
    finally:
        th.ak.finalize_columns = real
    check(len(launches) == 1, f"{name}: {len(launches)} K29 launches "
          "where one drains the state")
    want = plain(*args)
    torch.cuda.synchronize()
    # the same IEEE operations in the same order (no contraction): equal
    err = batch_err(torch, got, want, name, 0.0)
    return {"rows": got.capacity, "columns": len(got.columns),
            "max_abs_err": err,
            "ms": time_ms(lambda: fn(*args), torch),
            "plain_ms": time_ms(lambda: plain(*args), torch),
            "library_ms": None, "bound_ms": _bound(launches[0])}


def measure_composed(torch, fn, args):
    """A composed torch function at its largest call: its time and the
    bytes its arguments and new outputs hold (every argument tensor read
    once, every output tensor that is not an argument written once)."""
    out = fn(*args)
    ms = time_ms(lambda: fn(*args), torch)
    return {"rows": rows_of(*args), "ms": ms,
            "bound_ms": _bound(_moved(args, out))}


def _sort_leading(torch, batch, keys, desc, nf):
    lead = batch.columns[keys[0]].data
    return lambda: torch.sort(lead, stable=True, descending=bool(desc[0]))


def _topk_leading(torch, state, batch, n, keys, desc, nf):
    lead = torch.cat([state.columns[keys[0]].data,
                      batch.columns[keys[0]].data.to(
                          state.columns[keys[0]].data.dtype)])
    k = min(int(n), lead.shape[0])
    return lambda: torch.topk(lead, k, largest=bool(desc[0]))


def batch_bytes(batch, rows=None) -> int:
    """Bytes of `rows` rows (all by default) of every column's data and
    mask and of row_valid."""
    rows = batch.capacity if rows is None else rows
    return rows * (1 + sum(c.data.element_size() + 1
                           for c in batch.columns.values()))


def check_same_batch(torch, got, want, what):
    check(torch.equal(got.row_valid, want.row_valid)
          and got.names == want.names
          and all(torch.equal(got.columns[n].mask, want.columns[n].mask)
                  and torch.equal(got.columns[n].data[want.columns[n].mask],
                                  want.columns[n].data[want.columns[n].mask])
                  for n in want.names),
          f"{what} differs from its plain version")


def measure_k10(torch, mm, args):
    """K10 at one call of the main path against its plain version."""
    probe, build, _, _, out_cap = args
    got = mm.cross_product(*args)
    want = mm.cross_product_plain(*args)
    torch.cuda.synchronize()
    check_same_batch(torch, got, want, "K10 cross_product")
    ms = time_ms(lambda: mm.cross_product(*args), torch)
    plain_ms = time_ms(lambda: mm.cross_product_plain(*args), torch)
    # every column of both sides read once (the live counts come from
    # the caller, so row_valid is not read); every output slot written
    # once
    col_bytes = [sum(c.data.element_size() + 1 for c in b.columns.values())
                 for b in (probe, build)]
    moved = probe.capacity * col_bytes[0] + build.capacity * col_bytes[1] \
        + out_cap * (1 + sum(col_bytes))
    return {"probe_rows": probe.capacity, "build_rows": build.capacity,
            "out_capacity": out_cap, "live": int(want.row_valid.sum()),
            "columns": len(want.names), "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_k11(torch, tj, args):
    """K11 at the FULL join's outer tail against its plain version."""
    table, matched, probe_schema, build_output = args
    got, gcount = tj.unmatched_build(*args)
    want, wcount = tj.unmatched_build_plain(*args)
    torch.cuda.synchronize()
    check(int(gcount) == int(wcount), "K11 join_outer: live count differs")
    check_same_batch(torch, got, want, "K11 join_outer")
    ms = time_ms(lambda: tj.unmatched_build(*args), torch)
    plain_ms = time_ms(lambda: tj.unmatched_build_plain(*args), torch)
    n = matched.shape[0]
    probe_bytes = sum(got.columns[nm].data.element_size() + 1
                      for nm, _, _ in probe_schema)
    # row_valid, matched and the build masks read once; the liveness,
    # the build masks and the probe columns written once; the count
    moved = n * (2 + 2 * len(build_output) + 1 + probe_bytes) + 8
    return {"rows": n, "live": int(wcount), "matched": int(matched.sum()),
            "columns": len(probe_schema) + len(build_output),
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_distinct(torch, tsort, args):
    """The DISTINCT fold (K3 + K25 + K26 + K6) at its largest call
    against the same fold through the plain versions of K3, K25, K26 and
    K6."""
    state, batch = args
    got = tsort.distinct_step(*args)
    want = tsort.distinct_step_plain(*args)
    torch.cuda.synchronize()
    check_same_batch(torch, got, want, "the DISTINCT fold")
    ms = time_ms(lambda: tsort.distinct_step(*args), torch)
    plain_ms = time_ms(lambda: tsort.distinct_step_plain(*args), torch)
    # one PyTorch call computing the same set: unique rows of the live
    # (data, mask) columns
    live = torch.cat([state.row_valid, batch.row_valid])
    stacked = torch.stack([torch.cat([state.columns[n].data.to(torch.int64),
                                      batch.columns[n].data.to(torch.int64)])
                           for n in state.names]
                          + [torch.cat([state.columns[n].mask,
                                        batch.columns[n].mask])
                             .to(torch.int64) for n in state.names],
                          dim=1)[live]
    library_ms = time_ms(lambda: torch.unique(stacked, dim=0), torch)
    # state and batch read once; the new state written once
    moved = batch_bytes(state) + batch_bytes(batch) + batch_bytes(got)
    return {"rows": state.capacity + batch.capacity,
            "live": int(live.sum()), "kept": int(want.row_valid.sum()),
            "out_capacity": got.capacity, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def compare_fragment(torch, got, want, what):
    """K12's output against its composed form: row_valid and every
    mask exactly, every value under a set mask exactly (NaN equal to
    NaN). Returns (values compared, max abs difference)."""
    check(torch.equal(got.row_valid, want.row_valid)
          and list(got.columns) == list(want.columns),
          f"{what}: row_valid or columns differ from the composed form")
    compared, max_abs = 0, 0.0
    for name, w in want.columns.items():
        g = got.columns[name]
        check(g.data.dtype == w.data.dtype
              and torch.equal(g.mask, w.mask),
              f"{what}: {name}'s dtype or mask differs")
        a, b = g.data[w.mask], w.data[w.mask]
        if a.is_floating_point():
            nan = torch.isnan(b)
            check(torch.equal(torch.isnan(a), nan),
                  f"{what}: {name}'s NaNs differ")
            a, b = a[~nan], b[~nan]
        if a.numel():
            diff = (a.to(torch.float64) - b.to(torch.float64)).abs()
            max_abs = max(max_abs, float(diff.max()))
        check(torch.equal(a, b),
              f"{what}: {name} differs from the composed form")
        compared += int(w.mask.sum())
    return compared, max_abs


def measure_k12(torch, ff, kernel, batch, query):
    """K12 at one captured call: compared with its composed form on the
    same CUDA batch, then timed beside it. The bound is the bytes the
    kernel must move (the columns it reads and writes, once) over
    HBM_BYTES_PER_S; no single PyTorch call computes a chain."""
    got = kernel(batch)
    want = ff.compose_chain(kernel.stages, batch)
    torch.cuda.synchronize()
    compared, max_abs = compare_fragment(torch, got, want,
                                         f"K12 {kernel.fingerprint}")
    moved = kernel.io_bytes(batch)
    return {"fingerprint": kernel.fingerprint, "shape_from": query,
            "rows": batch.capacity, "stages": len(kernel.stages),
            "values_compared": compared, "max_abs_err": max_abs,
            "bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            "library_ms": None}


def device_ms(torch, fn, match=None) -> float:
    """Device time of one call of `fn` (the kernels whose name holds
    `match`, or every device event but copies and fills), from
    torch.profiler over ITERS calls after one warm-up: the part of
    time_ms that is not the host's launch work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if match is not None and match not in e.key:
            continue
        if e.key.lower().startswith(("memcpy", "memset")):
            continue
        total += getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
    return total / ITERS / 1e3


def time_k12(torch, tb, ff, kernel, batch, m):
    """K12 and its composed form timed from a cold L2: each call reads
    the next of several copies of `batch`, which together hold at least
    four times the card's L2, so a call finds none of its inputs there;
    the outputs of as many calls are kept alive, so no call writes into
    the buffers of the call before it (whose lines may still sit dirty
    in the L2).
    `ms` / `plain_ms` are CUDA events around the call (the host's
    launch work included), `device_ms` / `plain_device_ms` the device
    time alone; `warm_device_ms` is K12's device time on one batch
    again and again (its inputs then sit in the L2)."""
    m = dict(m)
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    copies = max(2, min(64, -(-4 * l2 // max(1, m["bytes"]))))

    def clone(b):
        return tb.Batch({n: tb.Column(c.data.clone(), c.mask.clone(),
                                      c.type, c.dictionary)
                         for n, c in b.columns.items()},
                        b.row_valid.clone())
    ring = itertools.cycle([batch] + [clone(batch)
                                      for _ in range(copies - 1)])
    held = collections.deque(maxlen=copies)

    def k12():
        held.append(kernel(next(ring)))

    def plain():
        held.append(ff.compose_chain(kernel.stages, next(ring)))
    m["l2_copies"] = copies
    m["ms"] = time_ms(k12, torch)
    m["plain_ms"] = time_ms(plain, torch)
    m["device_ms"] = device_ms(torch, k12, "fragment_kernel")
    m["plain_device_ms"] = device_ms(torch, plain)
    m["warm_device_ms"] = device_ms(torch, lambda: kernel(batch),
                                    "fragment_kernel")
    return m


#: the hand-written kernels, by launch counter: (route, source in the
#: repository, the reference function it replaces). Every entry of
#: presto_tpu_torch/native/cuda.py SOURCES is here (route cuda); K12
#: is generated per chain by presto_tpu_torch/expr/codegen.py.
KERNELS = {
    "direct_slot_reduce": ("cuda", "presto_tpu_torch/csrc/slot_reduce.cu",
                           "presto_tpu/ops/hashagg.py:884"),
    "compact": ("cuda", "presto_tpu_torch/csrc/compact.cu",
                "presto_tpu/batch.py:450"),
    "row_hash": ("cuda", "presto_tpu_torch/csrc/row_hash.cu",
                 "presto_tpu/ops/common.py:167"),
    "join_build": ("cuda", "presto_tpu_torch/csrc/join_build.cu",
                   "presto_tpu/ops/join.py:248"),
    "join_probe": ("cuda", "presto_tpu_torch/csrc/join_probe.cu",
                   "presto_tpu/ops/join.py:353"),
    "segment_reduce": ("cuda", "presto_tpu_torch/csrc/segment_reduce.cu",
                       "presto_tpu/ops/hashagg.py:569"),
    "semi_join": ("cuda", "presto_tpu_torch/csrc/semi_join.cu",
                  "presto_tpu/ops/join.py:708"),
    "stream_reduce": ("cuda", "presto_tpu_torch/csrc/stream_reduce.cu",
                      "presto_tpu/operators/aggregation.py:651"),
    "join_expand": ("cuda", "presto_tpu_torch/csrc/join_expand.cu",
                    "presto_tpu/ops/join.py:609"),
    "cross_product": ("cuda", "presto_tpu_torch/csrc/cross_product.cu",
                      "presto_tpu/operators/misc_ops.py:120"),
    "join_outer": ("cuda", "presto_tpu_torch/csrc/join_outer.cu",
                   "presto_tpu/ops/join.py:689"),
    "fragment": ("triton", "presto_tpu_torch/expr/codegen.py",
                 "presto_tpu/operators/fused_fragment.py:187"),
    "window_segments": ("cuda", "presto_tpu_torch/csrc/window_segments.cu",
                        "presto_tpu/ops/window.py:164"),
    "window_frame_sum": ("cuda",
                         "presto_tpu_torch/csrc/window_frame_sum.cu",
                         "presto_tpu/ops/window.py:285"),
    "window_frame_minmax": ("cuda",
                            "presto_tpu_torch/csrc/window_frame_minmax.cu",
                            "presto_tpu/ops/window.py:80"),
    "window_emit": ("cuda", "presto_tpu_torch/csrc/window_emit.cu",
                    "presto_tpu/ops/window.py:341"),
    "array_collect": ("cuda", "presto_tpu_torch/csrc/array_collect.cu",
                      "presto_tpu/operators/array_agg.py:66"),
    "exchange_shuffle": ("cuda", "presto_tpu_torch/csrc/exchange_shuffle.cu",
                         "presto_tpu/parallel/shuffle.py:233"),
    "merge_pair": ("cuda", "presto_tpu_torch/csrc/merge_pair.cu",
                   "presto_tpu/ops/merge.py:97"),
    "exchange_partition": ("cuda",
                           "presto_tpu_torch/csrc/exchange_partition.cu",
                           "presto_tpu/operators/exchange_ops.py:79"),
    "df_bounds": ("triton", "presto_tpu_torch/execution/dynamic_filters.py",
                  "presto_tpu/execution/dynamic_filters.py:177"),
    "df_distinct_set": ("cuda", "presto_tpu_torch/csrc/dynamic_filter.cu",
                        "presto_tpu/execution/dynamic_filters.py:210"),
    "df_apply": ("cuda", "presto_tpu_torch/csrc/dynamic_filter.cu",
                 "presto_tpu/execution/dynamic_filters.py:242"),
    "sort_encode": ("cuda", "presto_tpu_torch/csrc/sort_encode.cu",
                    "presto_tpu/ops/common.py:232"),
    "radix_sort": ("cuda", "presto_tpu_torch/csrc/radix_sort.cu",
                   "presto_tpu/ops/common.py:100"),
    "gather_rows": ("cuda", "presto_tpu_torch/csrc/gather_rows.cu",
                    "presto_tpu/ops/sort.py:22"),
    "limit_rank": ("cuda", "presto_tpu_torch/csrc/limit_rank.cu",
                   "presto_tpu/ops/sort.py:87"),
    "row_hash_sources": ("cuda", "presto_tpu_torch/csrc/row_hash.cu",
                         "presto_tpu/ops/hashagg.py:818"),
    "gather_rows_sources": ("cuda", "presto_tpu_torch/csrc/gather_rows.cu",
                            "presto_tpu/ops/hashagg.py:818"),
    "state_shrink": ("cuda", "presto_tpu_torch/csrc/state_shrink.cu",
                     "presto_tpu/operators/aggregation.py:83"),
    "agg_finalize": ("cuda", "presto_tpu_torch/csrc/agg_finalize.cu",
                     "presto_tpu/operators/aggregation.py:254"),
    "vector_reduce": ("cuda", "presto_tpu_torch/csrc/vector_reduce.cu",
                      "presto_tpu/ops/hashagg.py:884"),
}
#: the mesh path's kernels, measured there
MESH_KERNELS = ("exchange_shuffle", "merge_pair")
#: the kernels the server phase measures (K21-K23 are measured on the
#: TPC-H path, where LocalRunner's joins publish the same filters)
SERVER_KERNELS = ("exchange_partition",)
#: query label -> the single-device warm wall of the TPC-H path
SINGLE_WARM = {}
#: the main path's oracle rows by query label (run_phases fills it)
ORACLE_ROWS = {}
#: the window kernels, measured on the window and TPC-DS path
WINDOW_KERNELS = ("window_segments", "window_frame_sum",
                  "window_frame_minmax", "window_emit")
#: the array path's kernel, measured there
ARRAY_KERNELS = ("array_collect",)
#: the sort family's kernels, measured on the sort path (K25 at Q21's
#: build on the TPC-H path)
SORT_KERNELS = ("sort_encode", "radix_sort", "gather_rows", "limit_rank")
#: the aggregation path's kernel, measured there (K28, K29 and the
#: N-source K3 / K26 are measured on the TPC-H path)
AGG_KERNELS = ("vector_reduce",)

#: queries run again with fusion off (their walls beside the fused ones)
FUSION_OFF = ("q1", "q3", "q6", "q18")
#: queries whose CUDA kernel launches are counted fused and unfused
LAUNCH_PROFILE = ("q1", "q3", "q6")

#: the queries whose largest K10 call is held against the plain version:
#: Q19 at tiny (K10's largest call), Q11, Q22 (no live slot at SF1) and
#: Q22_EXISTS (tens of thousands of live probe rows x 1)
K10_AT = ("q19", "q11", "q22", "q22_exists")

#: the kernels each query's plan must launch (K12 in every one: each
#: plans at least one filter/project chain)
MUST = {"q1": ("direct_slot_reduce", "fragment"),
        "q6": ("direct_slot_reduce", "compact", "fragment"),
        "q3": ("row_hash", "join_build", "join_probe", "join_expand",
               "segment_reduce", "fragment", "sort_encode", "radix_sort",
               "gather_rows"),
        "q5": ("row_hash", "join_build", "join_probe", "join_expand",
               "direct_slot_reduce", "fragment", "radix_sort",
               "gather_rows"),
        "q13": ("row_hash", "join_build", "join_probe", "join_expand",
                "segment_reduce", "fragment"),
        "q4": ("row_hash", "join_build", "semi_join",
               "direct_slot_reduce", "fragment"),
        "q16": ("join_probe", "join_expand", "semi_join",
                "segment_reduce", "fragment", "sort_encode", "radix_sort",
                "gather_rows"),
        "q18": ("stream_reduce", "semi_join", "join_probe", "join_expand",
                "segment_reduce", "fragment"),
        "q20": ("semi_join", "join_probe", "join_expand",
                "segment_reduce", "fragment"),
        "q11": ("cross_product", "join_probe", "join_expand", "fragment"),
        "q15": ("join_probe", "join_expand", "fragment"),
        "q21": ("semi_join", "join_probe", "join_expand", "fragment"),
        "q22": ("cross_product", "semi_join", "fragment"),
        "q22_exists": ("cross_product", "semi_join", "fragment"),
        "full": ("join_expand", "join_outer", "fragment"),
        "distinct": ("row_hash", "segment_reduce", "fragment",
                     "radix_sort", "gather_rows"),
        "union": ("row_hash", "segment_reduce", "fragment"),
        "q19": ("cross_product", "fragment"),
        "q19_live": ("cross_product", "fragment")}


def run_phases(torch, np, mods, dev, schema, profile=True):
    """The tpch, profile and kernels phases on `dev`; returns the
    per-kernel summary, the path's launches of every kernel, and K25's
    figures at its largest join build. `mods` holds the port's modules by
    short name."""
    tb, tt, gen_module = mods["tb"], mods["tt"], mods["gen"]
    th, tc, tj, tk = mods["th"], mods["tc"], mods["tj"], mods["tk"]
    cg, ff = mods["codegen"], mods["ff"]
    # 3. tpch: the main path ------------------------------------------
    want_q1, want_q6, lineitem = oracle(np, gen_module, schema)
    want_q19, n_lineitem_q19 = q19_oracle(np, gen_module)
    want = {"q1": want_q1, "q6": want_q6, **want_q19,
            **join_oracle(np, gen_module, lineitem, schema),
            **semi_oracle(np, gen_module, lineitem, schema),
            **slice4_oracle(np, gen_module, lineitem, schema)}
    # the mesh path checks its TPC-H queries against the same rows
    ORACLE_ROWS.update(want)
    n_lineitem = {schema: len(lineitem["quantity"]),
                  Q19_SCHEMA: n_lineitem_q19}
    runners = {sc: mods["LocalRunner"]("tpch", sc, properties=PROPS,
                                       device=dev)
               for sc in {schema, Q19_SCHEMA}}

    def runner_of(label):
        return runners[QUERY_SCHEMA.get(label, schema)]
    counters = list(tk.COUNTERS.values())
    launches, calls, walls, results = {}, {}, {}, {}
    chains, compiles, decisions = {}, {}, {}
    # no chain may run its composed form on the card on the main path:
    # every call of it there is counted
    composed_on_card = []
    compose = ff.compose_chain

    def counting_compose(stages, batch):
        if batch.device.type != "cpu":
            composed_on_card.append(len(stages))
        return compose(stages, batch)
    ff.compose_chain = counting_compose
    try:
        for label, sql in QUERIES.items():
            runner = runner_of(label)
            for c in counters:
                c.launches = 0
            before = dict(tk.CALLS)
            c0 = dict(cg.COMPILES)
            f0 = collections.Counter(tk.FUSED_FRAGMENTS)
            t = time.perf_counter()
            res = runner.execute(sql)
            results[label] = res.rows()
            cold = time.perf_counter() - t
            launches[label] = {c.name: c.launches for c in counters}
            compiles[label] = (cg.COMPILES["count"] - c0["count"],
                               cg.COMPILES["seconds"] - c0["seconds"])
            calls[label] = {f: n - before.get(f, 0)
                            for f, n in tk.CALLS.items()
                            if n - before.get(f, 0)}
            rep = res.fusion_report
            check(rep is not None, f"{label}: fusion did not run")
            reasons = [str(e["reason"]) for e in rep["fragments"]]
            check(not any(r.startswith("not_lowered") for r in reasons),
                  f"{label}: a chain has no lowering: {reasons}")
            chains[label] = (rep["fused"], len(rep["fragments"]))
            # the fusion pass's decisions, as its counter counted them:
            # the report's, once per planning (a query re-planned after
            # an overflow is counted again)
            f1 = collections.Counter(tk.FUSED_FRAGMENTS)
            f1.subtract(f0)
            f1 = +f1
            mine = collections.Counter(
                (("partial" if e["reason"] else "fused") if e["fused"]
                 else "fallback", e["reason"] or "")
                for e in rep["fragments"])
            plans = sum(f1.values()) // max(1, len(rep["fragments"]))
            check(plans >= 1 and all(f1[k] == plans * n
                                     for k, n in mine.items())
                  and sum(f1.values()) == plans * len(rep["fragments"]),
                  f"{label}: FUSED_FRAGMENTS {dict(f1)} disagrees with "
                  f"the fusion report")
            by_status = collections.Counter()
            for (status, _), n in f1.items():
                by_status[status] += n // plans
            decisions[label] = {**by_status, "plans": plans}
            warm = []
            for _ in range(EARLIER_WARM):
                t = time.perf_counter()
                runner.execute(sql).rows()
                warm.append(time.perf_counter() - t)
            walls[label] = (cold, statistics.median(warm))
            SINGLE_WARM[label] = walls[label][1]
    finally:
        ff.compose_chain = compose
    check(not composed_on_card, "a filter/project chain ran its composed "
          f"form on the card {len(composed_on_card)} times")
    for label in QUERIES:
        check(result_matches(label, results[label], want[label]),
              f"{label} differs from the oracle: {results[label][:20]} vs "
              f"{want[label][:20]}")
    for label, names in MUST.items():
        for k in names:
            check(launches[label][k] > 0,
                  f"{k} was not launched in {label}")
    for label in QUERIES:
        cold, warm = walls[label]
        sc = QUERY_SCHEMA.get(label, schema)
        rows = results[label]
        emit({"phase": "tpch", "query": label, "schema": sc,
              "batch_rows": PROPS["batch_rows"],
              "rows": rows if len(rows) <= 200 else len(rows),
              "matches_oracle": True, "launches": launches[label],
              "family_calls": calls[label],
              "fused_chains": f"{chains[label][0]}/{chains[label][1]}",
              "fused_fragments": decisions[label],
              "cold_s": cold, "cold_k12_compiles": compiles[label][0],
              "cold_k12_compile_s": compiles[label][1], "warm_s": warm,
              "lineitem_rows": n_lineitem[sc],
              "warm_lineitem_rows_per_s": n_lineitem[sc] / warm})

    # 3b. fusion off (one-stage K12 kernels) ---------------------------
    # K12 records its largest call per generated kernel here too, so the
    # kernels only this path generates are held against their composed
    # form with the main path's
    unfused = mods["LocalRunner"]("tpch", schema, properties={
        **PROPS, "fragment_fusion_enabled": False}, device=dev)
    unfused_k12, unfused_query = {}, {}
    ff.compose_chain = counting_compose
    cg.CAPTURE = unfused_k12
    try:
        for label in FUSION_OFF:
            for c in counters:
                c.launches = 0
            seen = {fp: id(v[2]) for fp, v in unfused_k12.items()}
            t = time.perf_counter()
            res = unfused.execute(QUERIES[label])
            rows = res.rows()
            cold = time.perf_counter() - t
            k12 = tk.COUNTERS["fragment"].launches
            t = time.perf_counter()
            unfused.execute(QUERIES[label]).rows()
            warm = time.perf_counter() - t
            for fp, v in unfused_k12.items():
                if seen.get(fp) != id(v[2]):
                    unfused_query[fp] = label + "_unfused"
            check(res.fusion_report is None,
                  f"{label}: fusion ran with fragment_fusion_enabled off")
            check(result_matches(label, rows, want[label]),
                  f"{label} with fusion off differs from the oracle")
            check(k12 > 0, f"{label} with fusion off launched no K12")
            emit({"phase": "fusion_off", "query": label, "schema": schema,
                  "matches_oracle": True, "k12_launches": k12,
                  "cold_s": cold, "warm_s": warm,
                  "fused_cold_s": walls[label][0],
                  "fused_warm_s": walls[label][1]})
    finally:
        cg.CAPTURE = None
        ff.compose_chain = compose
    check(not composed_on_card, "a filter/project chain ran its composed "
          f"form on the card with fusion off {len(composed_on_card)} "
          "times")
    # Q19 at SF1: the reference's guard, before anything is materialized
    import re
    try:
        runners[schema].execute(Q19).rows()
        guard = None
    except RuntimeError as e:
        guard = str(e)
    check(guard is not None and re.fullmatch(GUARD, guard) is not None,
          f"q19 at {schema} did not raise the cross-join guard: {guard}")
    emit({"phase": "guard", "query": "q19", "schema": schema,
          "raised": guard})

    # 4. where a warm query's time goes --------------------------------
    if profile:
        for label, sql in QUERIES.items():
            emit({"phase": "profile", "query": label,
                  **profile_query(torch, gen_module, runner_of(label),
                                  sql)})
        for label in LAUNCH_PROFILE:
            emit({"phase": "profile", "query": label, "fusion": False,
                  **profile_query(torch, gen_module, unfused,
                                  QUERIES[label])})

    # 5. kernels at the main path's shapes ----------------------------
    with Capture(mods) as cap:
        for label, sql in QUERIES.items():
            cap.run(label, lambda: runner_of(label).execute(sql).rows())
    check({"q1", "q6"} <= set(cap.k1) and "q6" in cap.k2
          and set(cap.big) == {"row_hash", "join_build", "join_probe",
                               "segment_reduce", "semi_join",
                               "stream_reduce", "df_bounds",
                               "df_distinct_set", "df_apply"}
          and set(cap.expand) == {"aligned", "general"}
          and set(K10_AT) <= set(cap.k10)
          and cap.expand_full is not None and cap.expand_full[1] == "full"
          and cap.k11 is not None and cap.k11[1] == "full"
          and cap.distinct is not None and cap.distinct[1] == "distinct"
          and cap.build_sort is not None
          and set(cap.composed) == set(AGG_CALLS),
          "kernel inputs were not captured from the main path")
    k1 = {q: measure_k1(torch, th, cap.k1[q][1], q) for q in ("q1", "q6")}
    _, q6_batch, q6_cap = cap.k2["q6"]
    k2 = {"q6_shrink": measure_k2(torch, tb, q6_batch, q6_cap,
                                  "q6 shrink")}
    big = {k: v[2] for k, v in cap.big.items()}
    shape_from = {k: v[1] for k, v in cap.big.items()}
    measured = {
        "row_hash": measure_k3(torch, tc, big["row_hash"]),
        "join_build": measure_k4(torch, tj, big["join_build"]),
        "join_probe": measure_k5(torch, tc, tj, big["join_probe"]),
        "segment_reduce": measure_k6(torch, tc, th, big["segment_reduce"]),
        "semi_join": measure_k7(torch, tj, big["semi_join"]),
        "stream_reduce": measure_k8(torch, th, big["stream_reduce"]),
        "df_bounds": measure_k21(torch, mods["df"], big["df_bounds"]),
        "df_distinct_set": measure_k22(torch, mods["df"],
                                       big["df_distinct_set"]),
        "df_apply": measure_k23(torch, mods["df"], big["df_apply"])}
    set_fits = None if cap.df_set_fits is None else (
        cap.df_set_fits[1],
        measure_k22(torch, mods["df"], cap.df_set_fits[2]))
    expand = {layout: (q, measure_k9(
        torch, tj, args, {qq: n for (qq, lay), n in cap.expand_calls.items()
                          if lay == layout}))
        for layout, (_, q, args) in cap.expand.items()}
    _, fq, fargs, fmatched = cap.expand_full
    expand["full"] = (fq, measure_k9(torch, tj, fargs, {}, fmatched))
    k10 = {q: measure_k10(torch, mods["misc"], cap.k10[q][1])
           for q in K10_AT}
    k11 = measure_k11(torch, tj, cap.k11[2])
    distinct = measure_distinct(torch, mods["sort"], cap.distinct[2])
    # K25 at the largest join build, beside one stable torch.sort
    build_sort = {**measure_radix_sort(torch, tc, *cap.build_sort[2:]),
                  "shape_from": cap.build_sort[1]}
    # the aggregation state's calls at their largest: K3 / K26 over a
    # merge's sources, K28, the carried count, K29
    agg_at = {label: v[1] for label, v in cap.composed.items()}
    agg_args = {label: v[3] for label, v in cap.composed.items()}
    merge, k3_sources, k26_sources = measure_merge(
        torch, tc, th, agg_args["hashagg_merge merge_states"])
    agg_state = {
        "hashagg_merge merge_states": merge,
        "agg_shrink _shrink_state": measure_k28(
            torch, mods["ak"], mods["agg"],
            agg_args["agg_shrink _shrink_state"]),
        "agg_count _count_live": measure_count(
            torch, mods["agg"], mods["pages"],
            agg_args["agg_count _count_live"]),
        "agg_finalize finalize": measure_k29(
            torch, th, "finalize", agg_args["agg_finalize finalize"]),
        "agg_finalize direct_finalize": measure_k29(
            torch, th, "direct_finalize",
            agg_args["agg_finalize direct_finalize"])}
    # K12: every distinct generated kernel at its largest call against
    # its composed form; timed at the three largest by bytes and at
    # Q1's chain fused into its aggregation
    # (the fusion-off path's kernels where it made their largest call)
    k12_calls = dict(cap.k12)
    k12_query = dict(cap.k12_query)
    for fp, v in unfused_k12.items():
        if fp not in k12_calls or k12_calls[fp][0] < v[0]:
            k12_calls[fp] = v
            k12_query[fp] = unfused_query.get(fp, "?")
    k12 = {fp: (kern, batch, measure_k12(torch, ff, kern, batch,
                                         k12_query.get(fp, "?")))
           for fp, (_, kern, batch) in k12_calls.items()}
    check(bool(k12), "no K12 input was captured from the main path")
    check(set(k12) == set(cg.LAUNCHED),
          f"{len(set(cg.LAUNCHED) - set(k12))} generated kernels were "
          "launched but not held against their composed form")
    emit({"phase": "k12_compare", "kernels": len(k12),
          "first_launches": len(cg.LAUNCHED),
          "from_fusion_off": sum(1 for fp in k12
                                 if k12_query.get(fp, "").endswith(
                                     "_unfused")),
          "values_compared": sum(m["values_compared"]
                                 for _, _, m in k12.values()),
          "max_abs_err": max(m["max_abs_err"] for _, _, m in k12.values())})
    timed = sorted(k12, key=lambda fp: -k12[fp][2]["bytes"])[:3]
    q1_agg = [fp for fp, (kern, _, m) in k12.items()
              if m["shape_from"] == "q1" and kern.stages[-1].raw]
    check(len(q1_agg) == 1, "Q1's chain fused into its aggregation was "
          "not captured")
    k12_timed = {}
    for fp in dict.fromkeys(timed + q1_agg):
        kern, batch, m = k12[fp]
        k12_timed[fp] = time_k12(torch, tb, ff, kern, batch, m)
        emit({"phase": "kernels", "kernel": "fragment",
              "role": "q1 chain + aggregation keys/inputs"
              if fp in q1_agg else "largest by bytes",
              **k12_timed[fp],
              "calls": {qq: {f: c.get(f, 0) for f in
                             ("filter_project", "fragment")}
                        for qq, c in calls.items()}})
    del big, cap
    # a 1M-row lineitem-shaped batch (the seven columns Q1 reads) with
    # Q6's predicate as row_valid (~2% live, shrunk) and its complement
    # (~98% live, the full variant; Q1's own predicate keeps every row
    # of this generator)
    n = min(1 << 20, n_lineitem[schema])
    types = {"quantity": tt.DOUBLE, "extendedprice": tt.DOUBLE,
             "discount": tt.DOUBLE, "tax": tt.DOUBLE,
             "returnflag": tt.VARCHAR, "linestatus": tt.VARCHAR,
             "shipdate": tt.DATE}
    wide = tb.Batch.from_numpy({c: lineitem[c][:n] for c in types},
                               types, capacity=n, device=dev)
    q6_keep = q6_predicate(lineitem, gen_module)[:n]
    sel = {"q6_pred_1M": q6_keep, "not_q6_pred_1M": ~q6_keep}
    for label, keep in sel.items():
        b = tb.Batch(wide.columns, torch.from_numpy(keep).to(dev))
        live = int(keep.sum())
        cap_out = tb.operator_capacity(live)
        k2[label] = measure_k2(torch, tb, b,
                               cap_out if cap_out < n else n, label)
    for q, m in k1.items():
        emit({"phase": "kernels", "kernel": "direct_slot_reduce",
              "shape_from": q, **m})
    for q, m in k2.items():
        emit({"phase": "kernels", "kernel": "compact", "shape_from": q,
              **m})
    if set_fits is not None:
        emit({"phase": "kernels", "kernel": "df_distinct_set",
              "role": "largest call whose set fits",
              "shape_from": set_fits[0], **set_fits[1]})
    for k, m in measured.items():
        emit({"phase": "kernels", "kernel": k, "shape_from": shape_from[k],
              **m, **({"calls": {qq: c.get("dynamic_filter", 0)
                                 for qq, c in calls.items()}}
                      if k.startswith("df_") else {})})
    for layout, (q, m) in expand.items():
        emit({"phase": "kernels", "kernel": "join_expand",
              "shape_from": q, **m})
    for q, m in k10.items():
        emit({"phase": "kernels", "kernel": "cross_product",
              "shape_from": q, **m,
              "calls": {qq: c.get("nested_loop", 0)
                        for qq, c in calls.items()}})
    emit({"phase": "kernels", "kernel": "join_outer", "shape_from": "full",
          **k11})
    emit({"phase": "kernels", "kernel": "distinct (K3 + K25 + K26 + K6)",
          "family": "distinct", "shape_from": "distinct", **distinct,
          "calls": {qq: c.get("distinct", 0) for qq, c in calls.items()}})
    emit({"phase": "kernels", "kernel": "radix_sort", "role": "join build",
          "family": "join_build", **build_sort,
          "calls": {qq: c.get("join_build", 0) for qq, c in calls.items()}})
    # the aggregation state's calls: time at the largest call against
    # the plain version, byte bound, calls of the family per query
    merge_q = agg_at["hashagg_merge merge_states"]
    for label, m in agg_state.items():
        family = AGG_CALLS[label][0]
        emit({"phase": "kernels", "kernel": label, "family": family,
              "shape_from": agg_at[label], **m,
              "calls": {qq: c.get(family, 0) for qq, c in calls.items()}})
    for name, m in (("row_hash_sources", k3_sources),
                    ("gather_rows_sources", k26_sources)):
        emit({"phase": "kernels", "kernel": name, "family": "hashagg_merge",
              "shape_from": merge_q, **m})
    measured["row_hash_sources"] = k3_sources
    measured["gather_rows_sources"] = k26_sources
    measured["state_shrink"] = agg_state["agg_shrink _shrink_state"]
    measured["agg_finalize"] = agg_state["agg_finalize finalize"]

    measured["direct_slot_reduce"] = k1["q1"]
    measured["compact"] = k2["q6_shrink"]
    # K22's summary figures are those of its largest call whose set
    # fits: on overflow the kernel stops early and builds no set, which
    # is not the work torch.unique does (that call has its own line)
    if set_fits is not None:
        measured["df_distinct_set"] = set_fits[1]
    # the summary's K9 figures are those of its largest general call,
    # K10's those of its largest call (Q19 at tiny)
    measured["join_expand"] = expand["general"][1]
    measured["cross_product"] = k10["q19"]
    measured["join_outer"] = k11
    # K12's figures are those of its largest call by bytes
    measured["fragment"] = k12_timed[timed[0]]
    # every first launch of a generated kernel in this process (main
    # path, fusion off, capture and comparisons), and those inside the
    # main path's cold walls
    emit({"phase": "k12_compiles", "count": cg.COMPILES["count"],
          "seconds": cg.COMPILES["seconds"],
          "in_cold_walls": {q: {"count": n, "s": sec}
                            for q, (n, sec) in compiles.items()}})
    tpch_launches = {k: sum(v[k] for v in launches.values())
                     for k in KERNELS}
    kernels = []
    for k, (route, src, replaces) in KERNELS.items():
        if k in WINDOW_KERNELS or k in ARRAY_KERNELS or k in MESH_KERNELS \
                or k in SERVER_KERNELS or k in SORT_KERNELS \
                or k in AGG_KERNELS:
            continue
        m = measured[k]
        kernels.append({
            "name": k, "route": route, "source": src, "replaces": replaces,
            "family": tk.COUNTERS[k].family,
            "launches": tpch_launches[k],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": "bytes", "library_ms": m["library_ms"]})
    return kernels, tpch_launches, build_sort


# -- the window and TPC-DS path (K13-K16, GroupId) ------------------------

#: running aggregates over every lineitem (two window specs: the
#: default RANGE frame and a ROWS frame), wrapped in an outer aggregate
WIN_RUNNING = """select count(*), sum(rs), sum(rc), sum(rp), max(rc)
from (select
    sum(quantity) over (partition by orderkey order by linenumber) rs,
    count(*) over (partition by orderkey order by linenumber) rc,
    sum(extendedprice) over (partition by orderkey order by linenumber
                             rows unbounded preceding) rp
  from lineitem) t"""

_BY_CUST = "over (partition by custkey order by totalprice desc)"
#: the ranking functions over orders
WIN_RANK = f"""select count(*), sum(rn), sum(rk), sum(drk), sum(nt),
       sum(pr), sum(cd), max(rk)
from (select row_number() {_BY_CUST} rn, rank() {_BY_CUST} rk,
             dense_rank() {_BY_CUST} drk, ntile(4) {_BY_CUST} nt,
             percent_rank() {_BY_CUST} pr, cume_dist() {_BY_CUST} cd
  from orders) t"""

#: top three orders per customer: the TopN-row-number path
WIN_TOPN = f"""select count(*), sum(totalprice), sum(rn)
from (select custkey, totalprice, row_number() {_BY_CUST} rn
  from orders) t
where rn <= 3"""

_BY_SUPP = ("partition by suppkey order by shipdate, orderkey, "
            "linenumber")
#: sliding ROWS frames, lag / lead / first_value and RANGE offset frames
#: over each supplier's lines by ship date
WIN_FRAMES = f"""select count(*), sum(mn), sum(mx), sum(lg), sum(ld),
       sum(fv), sum(rc), sum(rs)
from (select
    min(extendedprice) over ({_BY_SUPP}
        rows between 5 preceding and 5 following) mn,
    max(extendedprice) over ({_BY_SUPP}
        rows between 5 preceding and 5 following) mx,
    lag(extendedprice) over ({_BY_SUPP}) lg,
    lead(quantity, 2) over ({_BY_SUPP}) ld,
    first_value(extendedprice) over ({_BY_SUPP}
        rows between 3 preceding and current row) fv,
    count(*) over (partition by suppkey order by shipdate
        range between 30 preceding and 30 following) rc,
    sum(quantity) over (partition by suppkey order by shipdate
        range between 7 preceding and current row) rs
  from lineitem) t"""

WIN_QUERIES = {"win_running": WIN_RUNNING, "win_rank": WIN_RANK,
               "win_topn": WIN_TOPN, "win_frames": WIN_FRAMES}

#: TPC-DS at sf1 (tests/tpcds_queries.py): the windowed revenue ratios
#: Q12, Q20, Q98, Q36's rollup (GroupId) and the q67-shape rank
_RATIO = """select {ids}i_item_desc, i_category, i_class, i_current_price,
       sum({p}_ext_sales_price) itemrevenue,
       sum({p}_ext_sales_price) * 100.0 /
         sum(sum({p}_ext_sales_price)) over (partition by i_class)
         revenueratio
from {sales}, item, date_dim
where {p}_item_sk = i_item_sk and {p}_sold_date_sk = d_date_sk
  and {pred}
group by {ids}i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, {ids}i_item_desc, revenueratio{limit}"""
DS_Q12 = _RATIO.format(ids="i_item_id, ", p="ws", sales="web_sales",
                       pred="d_year = 2000", limit="\nlimit 100")
DS_Q20 = _RATIO.format(ids="i_item_id, ", p="cs", sales="catalog_sales",
                       pred="d_year = 1999 and d_moy between 2 and 3",
                       limit="\nlimit 100")
DS_Q98 = _RATIO.format(ids="", p="ss", sales="store_sales",
                       pred="i_category in ('Sports', 'Books', 'Home') "
                            "and d_year = 1999", limit="")
DS_Q36 = """select sum(ss_net_profit) / sum(ss_ext_sales_price) gross_margin,
       i_category, i_class
from store_sales, date_dim, item, store
where d_date_sk = ss_sold_date_sk and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk and d_year = 2000
group by rollup (i_category, i_class)
order by i_category, i_class
limit 100"""
DS_Q104 = """select i_category, i_class, sumsales, rk
from (select i_category, i_class, sum(ss_ext_sales_price) sumsales,
             rank() over (partition by i_category
                          order by sum(ss_ext_sales_price) desc) rk
      from store_sales, date_dim, item
      where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
        and d_year = 2001
      group by i_category, i_class) t
where rk <= 3
order by i_category, rk, i_class"""
DS_SCHEMA = "sf1"
DS_QUERIES = {"ds_q12": DS_Q12, "ds_q20": DS_Q20, "ds_q98": DS_Q98,
              "ds_q36": DS_Q36, "ds_q104": DS_Q104}

#: the kernels each query of this path must launch (K12 is not
#: required: a chain whose outputs all pass through launches nothing;
#: that no chain ran its composed form on the card is checked instead)
WIN_MUST = {"win_running": ("window_segments", "window_frame_sum",
                            "window_emit"),
            "win_rank": ("window_segments", "window_emit"),
            "win_topn": ("window_segments", "window_emit"),
            "win_frames": ("window_segments", "window_frame_sum",
                           "window_frame_minmax", "window_emit"),
            "ds_q12": ("window_segments", "window_frame_sum",
                       "window_emit", "join_probe"),
            "ds_q20": ("window_segments", "window_frame_sum",
                       "window_emit", "join_probe"),
            "ds_q98": ("window_segments", "window_frame_sum",
                       "window_emit", "join_probe"),
            "ds_q36": ("join_probe",),
            "ds_q104": ("window_segments", "window_emit", "join_probe")}


def _q36_key(row):
    """Q36's ORDER BY (category, class; NULLs last), then the margin:
    a data group whose class is NULL ties with its category's rollup
    row, so rows equal on the ORDER BY keys may come in either order."""
    gm, cat, cls = row
    return (cat is None, cat or "", cls is None, cls or "",
            float("-inf") if gm is None else gm)


def window_rows_match(label, got, want) -> bool:
    """rows_match, with Q36's ties on its ORDER BY keys compared as a
    multiset (the engine's order must still follow the keys)."""
    if label == "ds_q36":
        keys = [_q36_key(r)[:4] for r in got]
        return keys == sorted(keys) and rows_match(
            sorted(got, key=_q36_key), sorted(want, key=_q36_key))
    return rows_match(got, want)


def first_difference(got, want):
    """(index, got row, oracle row) of the first rows that differ."""
    for i, (g, w) in enumerate(zip(got, want)):
        if not rows_match([g], [w]):
            return i, g, w
    return min(len(got), len(want)), None, None


def _group_starts(np, *keys):
    """Over rows sorted by `keys`: True where a key changes."""
    n = len(keys[0])
    start = np.zeros(n, bool)
    start[0] = True
    for k in keys:
        start[1:] |= k[1:] != k[:-1]
    return start


def _seg_first(np, start):
    """Index of each row's group start."""
    return np.maximum.accumulate(np.where(start, np.arange(len(start)), 0))


def window_oracle(np, gen_module, schema=SCHEMA):
    """WIN_RUNNING, WIN_RANK, WIN_TOPN and WIN_FRAMES in numpy over the
    same generated lineitem and orders."""
    gen = gen_module.TpchGenerator(gen_module.TpchConnector.SCHEMAS[schema])
    li = lineitem_table(np, gen, ("orderkey", "linenumber", "quantity",
                                  "extendedprice", "suppkey", "shipdate"))
    out = {}
    # running sums per order by line number (line numbers are unique
    # within an order, so the RANGE and ROWS frames agree)
    o = np.lexsort((li["linenumber"], li["orderkey"]))
    ok, ln = li["orderkey"][o], li["linenumber"][o]
    q, p = li["quantity"][o], li["extendedprice"][o]
    start = _group_starts(np, ok)
    check(not (~start[1:] & (ln[1:] == ln[:-1])).any(),
          "lineitem (orderkey, linenumber) is not unique")
    first = _seg_first(np, start)
    pos = np.arange(len(ok))
    cq, cp = np.cumsum(q), np.cumsum(p)
    rs = cq - (cq - q)[first]
    rp = cp - (cp - p)[first]
    rc = pos - first + 1
    out["win_running"] = [(len(ok), float(rs.sum()), int(rc.sum()),
                           float(rp.sum()), int(rc.max()))]
    # the ranking functions per customer by total price, descending
    orders = table(np, gen, "orders", ("custkey", "totalprice"))
    o = np.lexsort((-orders["totalprice"], orders["custkey"]))
    ck, tp = orders["custkey"][o], orders["totalprice"][o]
    n = len(ck)
    pos = np.arange(n)
    pstart_b = _group_starts(np, ck)
    peer_b = _group_starts(np, ck, tp)
    pstart = _seg_first(np, pstart_b)
    peer_start = _seg_first(np, peer_b)
    pid = np.cumsum(pstart_b) - 1
    psize = np.bincount(pid)[pid]
    peer_id = np.cumsum(peer_b) - 1
    peer_end = peer_start + np.bincount(peer_id)[peer_id] - 1
    dense = np.cumsum(peer_b)
    rn = pos - pstart + 1
    rk = peer_start - pstart + 1
    drk = dense - dense[pstart] + 1
    nq, nr = psize // 4, psize % 4
    idx = pos - pstart
    cut = nr * (nq + 1)
    nt = np.where(idx < cut, idx // np.maximum(nq + 1, 1) + 1,
                  nr + (idx - cut) // np.maximum(nq, 1) + 1)
    pr = np.where(psize > 1, (rk - 1) / np.maximum(psize - 1, 1), 0.0)
    cd = (peer_end - pstart + 1) / psize
    out["win_rank"] = [(n, int(rn.sum()), int(rk.sum()), int(drk.sum()),
                        int(nt.sum()), float(pr.sum()), float(cd.sum()),
                        int(rk.max()))]
    top = rn <= 3
    out["win_topn"] = [(int(top.sum()), float(tp[top].sum()),
                        int(rn[top].sum()))]
    # frames per supplier by ship date (ties broken by order and line)
    o = np.lexsort((li["linenumber"], li["orderkey"], li["shipdate"],
                    li["suppkey"]))
    sk, sd = li["suppkey"][o], li["shipdate"][o].astype(np.int64)
    p, q = li["extendedprice"][o], li["quantity"][o]
    n = len(sk)
    pos = np.arange(n)
    mn = np.full(n, np.inf)
    mx = np.full(n, -np.inf)
    for d in range(-5, 6):
        j = np.clip(pos + d, 0, n - 1)
        same = (pos + d >= 0) & (pos + d < n) & (sk[j] == sk)
        mn = np.where(same, np.minimum(mn, p[j]), mn)
        mx = np.where(same, np.maximum(mx, p[j]), mx)
    prev = np.r_[False, sk[1:] == sk[:-1]]
    lg = p[np.maximum(pos - 1, 0)][prev]
    nxt2 = np.r_[sk[2:] == sk[:-2], False, False]
    ld = q[np.minimum(pos + 2, n - 1)][nxt2]
    first = _seg_first(np, _group_starts(np, sk))
    fv = p[np.maximum(first, pos - 3)]
    key = sk * 100_000 + sd
    rc = np.searchsorted(key, key + 30, "right") \
        - np.searchsorted(key, key - 30, "left")
    cq = np.r_[0.0, np.cumsum(q)]
    rs = cq[np.searchsorted(key, key, "right")] \
        - cq[np.searchsorted(key, key - 7, "left")]
    out["win_frames"] = [(n, float(mn.sum()), float(mx.sum()),
                          float(lg.sum()), float(ld.sum()),
                          float(fv.sum()), int(rc.sum()), float(rs.sum()))]
    return out, len(li["orderkey"]), len(orders["custkey"])


def ds_table(np, gen, name, cols):
    """Columns (data, not-NULL mask) of a whole generated TPC-DS table."""
    n = gen.rows(name)
    step = 1 << 20
    data = {c: [] for c in cols}
    mask = {c: [] for c in cols}
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        d, m = gen.generate(name, lo, hi, list(cols))
        for c in cols:
            data[c].append(d[c])
            mask[c].append(m.get(c, np.ones(hi - lo, bool)))
    return ({c: np.concatenate(v) for c, v in data.items()},
            {c: np.concatenate(v) for c, v in mask.items()})


def _sort_key(row, cols):
    """ORDER BY on `cols` ascending, NULLs last."""
    return tuple((row[c] is None, row[c] if row[c] is not None else 0)
                 for c in cols)


def tpcds_oracle(np, ds_module, schema=DS_SCHEMA):
    """Q12, Q20, Q98, Q36 and Q104 in numpy over the same generated
    tables: sales rows keep a non-NULL item and date, items by their
    unique surrogate key, groups by the decoded attribute tuples."""
    gen = ds_module.TpcdsGenerator(ds_module.TpcdsConnector.SCHEMAS[schema])
    icols = ("i_item_sk", "i_item_id", "i_item_desc", "i_category",
             "i_class", "i_current_price")
    item, imask = ds_table(np, gen, "item", icols)
    isch = gen.schema("item")

    def attr(c):
        dic = isch.column(c).dictionary
        vals = item[c]
        return [None if not m else (dic[v] if dic is not None
                                    else (float(v) if c == "i_current_price"
                                          else v))
                for v, m in zip(vals.tolist(), imask[c].tolist())]
    attrs = {c: attr(c) for c in icols[1:]}
    row_of_sk = {int(sk): i for i, sk in enumerate(item["i_item_sk"])}
    dd, _ = ds_table(np, gen, "date_dim", ("d_date_sk", "d_year", "d_moy"))
    sk_lo = int(dd["d_date_sk"].min())
    yr = np.zeros(int(dd["d_date_sk"].max()) - sk_lo + 1, np.int64)
    mo = np.zeros_like(yr)
    yr[dd["d_date_sk"] - sk_lo] = dd["d_year"]
    mo[dd["d_date_sk"] - sk_lo] = dd["d_moy"]

    def sales(name, p, extra=()):
        cols = (f"{p}_item_sk", f"{p}_sold_date_sk", f"{p}_ext_sales_price",
                *extra)
        d, m = ds_table(np, gen, name, cols)
        keep = m[cols[0]] & m[cols[1]]
        date = d[cols[1]]
        inside = (date >= sk_lo) & (date < sk_lo + len(yr))
        keep &= inside
        di = np.where(inside, date - sk_lo, 0)
        return d, m, keep, yr[di], mo[di]

    out = {}
    for label, (name, p, pred, ids, limit) in {
            "ds_q12": ("web_sales", "ws", lambda y, m: y == 2000, True, 100),
            "ds_q20": ("catalog_sales", "cs",
                       lambda y, m: (y == 1999) & (m >= 2) & (m <= 3), True,
                       100),
            "ds_q98": ("store_sales", "ss", lambda y, m: y == 1999, False,
                       None)}.items():
        d, m, keep, y, mm = sales(name, p)
        keep &= pred(y, mm) & m[f"{p}_ext_sales_price"]
        items = d[f"{p}_item_sk"][keep]
        rev = np.bincount(items, weights=d[f"{p}_ext_sales_price"][keep],
                          minlength=len(item["i_item_sk"]) + 2)
        hit = np.bincount(items, minlength=len(rev)) > 0
        cols = (["i_item_id"] if ids else []) + [
            "i_item_desc", "i_category", "i_class", "i_current_price"]
        groups = {}
        for sk in np.flatnonzero(hit).tolist():
            i = row_of_sk[sk]
            if label == "ds_q98" and attrs["i_category"][i] not in (
                    "Sports", "Books", "Home"):
                continue
            g = tuple(attrs[c][i] for c in cols)
            groups[g] = groups.get(g, 0.0) + float(rev[sk])
        by_class = {}
        for g, v in groups.items():
            by_class[g[-2]] = by_class.get(g[-2], 0.0) + v
        rows = [dict(zip(cols, g), itemrevenue=v,
                     revenueratio=v * 100.0 / by_class[g[-2]])
                for g, v in groups.items()]
        order = ["i_category", "i_class"] + (["i_item_id"] if ids else []) \
            + ["i_item_desc", "revenueratio"]
        rows.sort(key=lambda r: _sort_key(r, order))
        rows = rows[:limit] if limit else rows
        out[label] = [tuple(r[c] for c in cols)
                      + (r["itemrevenue"], r["revenueratio"]) for r in rows]
    # Q36 (rollup) and Q104 over store_sales
    d, m, keep, y, _ = sales("store_sales", "ss",
                             ("ss_store_sk", "ss_net_profit"))
    nstore = gen.rows("store")
    st = d["ss_store_sk"]
    k36 = keep & (y == 2000) & m["ss_store_sk"] & (st >= 1) \
        & (st <= nstore)
    cat = np.array([attrs["i_category"][row_of_sk[s]]
                    for s in item["i_item_sk"].tolist()], object)
    cls = np.array([attrs["i_class"][row_of_sk[s]]
                    for s in item["i_item_sk"].tolist()], object)
    base = int(item["i_item_sk"].min())

    def rollup(mask_rows):
        """Per rollup group: [sum, rows] of the non-NULL net profits and
        of the non-NULL sales prices."""
        it = d["ss_item_sk"][mask_rows] - base
        cols = [(d[c][mask_rows].tolist(), m[c][mask_rows].tolist())
                for c in ("ss_net_profit", "ss_ext_sales_price")]
        sums = {}
        for r, (c, k) in enumerate(zip(cat[it].tolist(), cls[it].tolist())):
            # the grouping set is part of the group: a NULL class of the
            # data is not the rollup's NULL
            for g in ((0, c, k), (1, c, None), (2, None, None)):
                s = sums.setdefault(g, [0.0, 0, 0.0, 0])
                for j, (vals, ok) in enumerate(cols):
                    if ok[r]:
                        s[2 * j] += vals[r]
                        s[2 * j + 1] += 1
        return sums
    sums = rollup(k36)
    rows = [dict(gross_margin=a / b if na and nb else None, i_category=c,
                 i_class=k)
            for (_, c, k), (a, na, b, nb) in sums.items()]
    rows.sort(key=lambda r: _sort_key(r, ["i_category", "i_class"]))
    out["ds_q36"] = [(r["gross_margin"], r["i_category"], r["i_class"])
                     for r in rows[:100]]
    k104 = keep & (y == 2001) & m["ss_ext_sales_price"]
    it = d["ss_item_sk"][k104] - base
    sums = {}
    for c, k, v in zip(cat[it].tolist(), cls[it].tolist(),
                       d["ss_ext_sales_price"][k104].tolist()):
        sums[(c, k)] = sums.get((c, k), 0.0) + v
    rows = []
    for c in {c for c, _ in sums}:
        part = [(v, k) for (cc, k), v in sums.items() if cc == c]
        for v, k in part:
            rk = 1 + sum(1 for w, _ in part if w > v)
            if rk <= 3:
                rows.append((c, k, v, rk))
    rows.sort(key=lambda r: (r[0] is None, r[0] or "", r[3],
                             r[1] is None, r[1] or ""))
    out["ds_q104"] = rows
    return out, gen.rows("store_sales")


class WindowCapture:
    """The inputs of the largest call (by rows) of K13-K16 during one
    run of the window and TPC-DS queries: references (the window pass
    writes no input after the call)."""

    NAMES = ("window_segments", "window_frame_sum", "window_frame_minmax",
             "window_emit")

    def __init__(self, tw):
        self.tw = tw
        self.big = {}  # kernel -> (rows, query, args)
        self.query = None
        self._orig = {}

    def __enter__(self):
        def make(name, orig):
            def rec(*args):
                rows = rows_of(*args)
                if rows > self.big.get(name, (0,))[0]:
                    self.big[name] = (rows, self.query, args)
                return orig(*args)
            return rec
        for name in self.NAMES:
            self._orig[name] = getattr(self.tw, name)
            setattr(self.tw, name, make(name, self._orig[name]))
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self.tw, name, orig)
        return False


def _seg_bytes(seg, names):
    return sum(getattr(seg, n).numel() * 8 for n in names)


def _frame_seg_names(frame):
    names = ["pstart", "part_end"]
    if frame.mode == "range":
        names += ["peer_start", "peer_end"]
    return names


def _col_bytes(col):
    return 0 if col is None else col[0].numel() * col[0].element_size() \
        + col[1].numel()


def _cmp_cols(torch, got, want, what, exact_float=True):
    """Masks exactly; values under a set mask exactly (NaN equal to NaN)
    or, for float64 with exact_float False, to a relative 1e-9. Returns
    the largest absolute difference."""
    gd, gm = got
    wd, wm = want
    check(torch.equal(gm, wm), f"{what}: masks differ")
    a, b = gd[wm], wd[wm]
    check(a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}")
    if not a.is_floating_point():
        check(torch.equal(a, b), f"{what}: values differ")
        return 0.0
    nan = torch.isnan(a)
    check(torch.equal(nan, torch.isnan(b)), f"{what}: NaN positions differ")
    a, b = a[~nan], b[~nan]
    if a.numel() == 0:
        return 0.0
    same = a == b    # equal infinities included
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    if exact_float:
        check(bool(same.all()), f"{what}: values differ")
    else:
        check(bool(torch.all(same | (diff <= 1e-9 * b.abs()))),
              f"{what}: float values differ beyond rel 1e-9")
    return float(diff.max())


def measure_window(torch, tw, name, args):
    """One of K13-K16 at its largest call against its plain version on
    the same CUDA inputs, both timed; the bound is the bytes the kernel
    must move (each input it reads once, each output written once) over
    HBM_BYTES_PER_S."""
    plain = {"window_segments": tw.segments_plain,
             "window_frame_sum": tw.frame_sum_plain,
             "window_frame_minmax": tw.frame_minmax_plain,
             "window_emit": tw.emit_plain}[name]
    kern = getattr(tw, name)
    got = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    max_abs = 0.0
    if name == "window_segments":
        spart, sorder, svalid = args
        for f in ("pid", "pstart", "part_end", "peer_start", "peer_end",
                  "dense"):
            check(torch.equal(getattr(got, f), getattr(want, f)),
                  f"K13 window_segments: {f} differs from its plain version")
        n = svalid.shape[0]
        moved = nbytes(svalid) + sum(nbytes(d, m) for d, m in
                                     list(spart) + list(sorder)) + 6 * 8 * n
        info = {"rows": n, "part_keys": len(spart),
                "order_keys": len(sorder)}
    elif name in ("window_frame_sum", "window_frame_minmax"):
        if name == "window_frame_sum":
            seg, order, fn, vals, filt, svalid, frame, dt = args
        else:
            seg, order, fn, vals, filt, svalid, frame = args
        max_abs = _cmp_cols(torch, got, want, name,
                            exact_float=name == "window_frame_minmax")
        n = svalid.shape[0]
        ord_bytes = nbytes(order.data, order.mask) \
            if order is not None and frame.mode == "range" \
            and not (frame.start in ("u", "c") and frame.end in ("u", "c")) \
            else 0
        moved = nbytes(svalid) + _seg_bytes(seg, _frame_seg_names(frame)) \
            + ord_bytes + _col_bytes(vals) + _col_bytes(filt) \
            + nbytes(got[0]) + nbytes(got[1])
        info = {"rows": n, "function": fn, "frame": [frame.mode,
                                                     frame.start, frame.end]}
    else:
        seg, order, svalid, iota, emits = args
        for e, g, w in zip(emits, got, want):
            max_abs = max(max_abs, _cmp_cols(torch, g, w,
                                             f"K16 window_emit {e.kind}"))
        n = svalid.shape[0]
        used = {"pstart", "part_end"}
        srcs = 0
        for e in emits:
            if e.kind in ("rank", "percent_rank"):
                used.add("peer_start")
            if e.kind == "cume_dist":
                used.add("peer_end")
            if e.kind == "dense_rank":
                used.add("dense")
            if e.kind in ("lag", "lead"):
                used.add("pid")
            if e.frame is not None and e.kind not in ("lag", "lead"):
                used.update(_frame_seg_names(e.frame))
            srcs += _col_bytes(e.src)
        moved = nbytes(svalid, iota) + _seg_bytes(seg, used) + srcs \
            + sum(nbytes(d, m) for d, m in got)
        info = {"rows": n, "emits": [e.kind for e in emits]}
    ms = time_ms(lambda: kern(*args), torch)
    plain_ms = time_ms(lambda: plain(*args), torch)
    return {**info, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def run_window_phases(torch, np, mods, dev, schema):
    """The window and TPC-DS path: WIN_QUERIES at `schema` and
    DS_QUERIES at DS_SCHEMA through LocalRunner, rows against numpy
    oracles, every kernel's launches per query, cold and warm walls, a
    profile of one warm execution each, every new K12 kernel held
    against its composed form, and K13-K16 at their largest call
    against their plain versions. Returns {kernel: measurement} and
    {kernel: launches on this path}."""
    tk, cg, ff, tw = mods["tk"], mods["codegen"], mods["ff"], mods["tw"]
    t = time.perf_counter()
    want, n_lineitem, n_orders = window_oracle(np, mods["gen"], schema)
    want_ds, n_store_sales = tpcds_oracle(np, mods["ds"], DS_SCHEMA)
    emit({"phase": "window_oracle", "seconds": time.perf_counter() - t})
    runners = {"tpch": mods["LocalRunner"]("tpch", schema, properties=PROPS,
                                           device=dev),
               "tpcds": mods["LocalRunner"]("tpcds", DS_SCHEMA,
                                            properties=PROPS, device=dev)}
    queries = {**{k: ("tpch", v) for k, v in WIN_QUERIES.items()},
               **{k: ("tpcds", v) for k, v in DS_QUERIES.items()}}
    want = {**want, **want_ds}
    counters = list(tk.COUNTERS.values())
    launched_before = set(cg.LAUNCHED)
    composed_on_card = []
    compose = ff.compose_chain

    def counting_compose(stages, batch):
        if batch.device.type != "cpu":
            composed_on_card.append(len(stages))
        return compose(stages, batch)
    launches, lines = {}, {}
    ff.compose_chain = counting_compose
    try:
        for label, (cat, sql) in queries.items():
            runner = runners[cat]
            for c in counters:
                c.launches = 0
            before = dict(tk.CALLS)
            c0 = dict(cg.COMPILES)
            t = time.perf_counter()
            res = runner.execute(sql)
            rows = res.rows()
            cold = time.perf_counter() - t
            launches[label] = {c.name: c.launches for c in counters}
            calls = {f: n - before.get(f, 0) for f, n in tk.CALLS.items()
                     if n - before.get(f, 0)}
            rep = res.fusion_report
            check(rep is not None, f"{label}: fusion did not run")
            check(not any(str(e["reason"]).startswith("not_lowered")
                          for e in rep["fragments"]),
                  f"{label}: a chain has no lowering")
            warm = []
            for _ in range(WINDOW_WARM):
                t = time.perf_counter()
                runner.execute(sql).rows()
                warm.append(time.perf_counter() - t)
            check(window_rows_match(label, rows, want[label]),
                  f"{label} differs from the oracle: {len(rows)} rows vs "
                  f"{len(want[label])}; first difference "
                  f"{first_difference(rows, want[label])}")
            for k in WIN_MUST[label]:
                check(launches[label][k] > 0,
                      f"{k} was not launched in {label}")
            lines[label] = {
                "phase": "window" if cat == "tpch" else "tpcds",
                "query": label,
                "schema": schema if cat == "tpch" else DS_SCHEMA,
                "batch_rows": PROPS["batch_rows"],
                "rows": rows if len(rows) <= 12 else len(rows),
                "matches_oracle": True, "launches": launches[label],
                "family_calls": calls,
                "fused_chains": f"{rep['fused']}/{len(rep['fragments'])}",
                "cold_s": cold,
                "cold_k12_compiles": cg.COMPILES["count"] - c0["count"],
                "cold_k12_compile_s": cg.COMPILES["seconds"]
                - c0["seconds"], "warm_s": statistics.median(warm)}
    finally:
        ff.compose_chain = compose
    check(not composed_on_card, "a filter/project chain ran its composed "
          f"form on the card {len(composed_on_card)} times")
    for label, line in lines.items():
        emit(line)
    emit({"phase": "window_sizes", "lineitem_rows": n_lineitem,
          "orders_rows": n_orders, "store_sales_rows": n_store_sales})
    # where a warm query's time goes
    for label, (cat, sql) in queries.items():
        gen_cls = mods["gen"].TpchGenerator if cat == "tpch" \
            else mods["ds"].TpcdsGenerator
        emit({"phase": "profile", "query": label,
              **profile_query(torch, mods["gen"], runners[cat], sql,
                              gen_cls)})
    # kernels at this path's shapes, and every K12 kernel it generated
    cg.CAPTURE = {}
    k12_query = {}
    try:
        with WindowCapture(tw) as cap:
            for label, (cat, sql) in queries.items():
                cap.query = label
                seen = {fp: id(v[2]) for fp, v in cg.CAPTURE.items()}
                runners[cat].execute(sql).rows()
                for fp, v in cg.CAPTURE.items():
                    if seen.get(fp) != id(v[2]):
                        k12_query[fp] = label
        k12_calls = cg.CAPTURE
    finally:
        cg.CAPTURE = None
    check(set(cap.big) == set(WindowCapture.NAMES),
          f"window kernel inputs were not captured: {sorted(cap.big)}")
    compared = {}
    for fp, (_, kern, batch) in k12_calls.items():
        compared[fp] = measure_k12(torch, ff, kern, batch,
                                   k12_query.get(fp, "?"))
    new = set(cg.LAUNCHED) - launched_before
    check(new <= set(compared), f"{len(new - set(compared))} generated "
          "kernels of the window path were not held against their "
          "composed form")
    emit({"phase": "k12_compare", "path": "window", "kernels": len(compared),
          "new_first_launches": len(new),
          "values_compared": sum(m["values_compared"]
                                 for m in compared.values()),
          "max_abs_err": max([m["max_abs_err"] for m in compared.values()],
                             default=0.0)})
    measured = {}
    for name in WindowCapture.NAMES:
        _, q, args = cap.big[name]
        measured[name] = measure_window(torch, tw, name, args)
        emit({"phase": "kernels", "kernel": name, "family": "window",
              "shape_from": q, **measured[name],
              "launches": {label: launches[label][name]
                           for label in queries}})
    totals = {name: sum(launches[label][name] for label in queries)
              for name in tk.COUNTERS}
    return measured, totals


# -- the array path: array_agg / map_agg, UNNEST, the memory connector, ----
# -- and the repaired key caps (C6) and round(x, d) (C7) --------------------

ARR_ORDERS = """select orderkey, array_agg(partkey) p,
    array_agg(quantity) filter (where returnflag = 'R') rq
from lineitem group by orderkey"""
#: ordered, so K24-K26 carry its arrays' slot columns
ARR_CUST = """select custkey, array_agg(orderkey) o, array_agg(totalprice) t
from orders group by custkey order by custkey"""
MAP_LINES = """select orderkey, map_agg(linenumber, extendedprice) m
from lineitem where shipdate >= date '1995-01-01' group by orderkey"""
UNNEST_BACK = """select count(*), sum(x) from (select array_agg(partkey) p
    from lineitem group by orderkey) t cross join unnest(t.p) u(x)"""
CTAS_ARR = (
    "create table memory.default.order_parts as select orderkey, "
    "array_agg(partkey) p from lineitem group by orderkey",
    "select orderkey, cardinality(p) c from memory.default.order_parts",
    "select count(*), sum(x) from memory.default.order_parts t "
    "cross join unnest(t.p) u(x)",
    "drop table memory.default.order_parts")
#: C6: nine group keys (sort-based grouping, K6 with a second key
#: group) and a nine-key self-join of lineitem (K5 / K9 over key groups)
C6_KEYS = ("orderkey", "partkey", "suppkey", "linenumber", "quantity",
           "returnflag", "linestatus", "shipdate", "shipmode")
C6_GROUP = ("select orderkey % 1000 g0, linenumber, partkey % 7 g2, "
            "returnflag, linestatus, shipmode, shipinstruct, tax, discount, "
            "count(*) c, sum(extendedprice) s from lineitem "
            "where orderkey < 240000 group by 1, 2, 3, 4, 5, 6, 7, 8, 9")
C6_JOIN = ("select count(*), sum(a.extendedprice) from lineitem a join "
           "lineitem b on " + " and ".join(f"a.{k} = b.{k}" for k in C6_KEYS)
           + " where a.orderkey < 600000")
#: C7: round with a column scale, through K12
C7_ROUND = ("select custkey, round(acctbal, nationkey % 3) r "
            "from customer")
ARRAY_QUERIES = {"arr_orders": ARR_ORDERS, "arr_cust": ARR_CUST,
                 "map_lines": MAP_LINES, "unnest_back": UNNEST_BACK,
                 "ctas_arr": CTAS_ARR, "c6_group9": C6_GROUP,
                 "c6_join9": C6_JOIN, "c7_round": C7_ROUND}
ARRAY_MUST = {"arr_orders": ("array_collect", "window_segments", "fragment"),
              "arr_cust": ("array_collect", "window_segments", "sort_encode",
                           "radix_sort", "gather_rows"),
              "map_lines": ("array_collect", "fragment"),
              "unnest_back": ("array_collect",),
              "ctas_arr": ("array_collect",),
              "c6_group9": ("segment_reduce", "fragment"),
              "c6_join9": ("join_probe", "join_expand", "fragment"),
              "c7_round": ("fragment",)}
#: warm executions per query of the array path (the median)
ARRAY_WARM = 3


class DatagenTimer:
    """Sums the host seconds of every `generate` call of a generator
    class while active (the datagen share of a wall)."""

    def __init__(self, gen_cls):
        self.gen_cls = gen_cls
        self.seconds = 0.0

    def __enter__(self):
        orig = self.orig = self.gen_cls.generate
        timer = self

        def timed(gen, *args, **kwargs):
            t = time.perf_counter()
            try:
                return orig(gen, *args, **kwargs)
            finally:
                timer.seconds += time.perf_counter() - t
        self.gen_cls.generate = timed
        return self

    def __exit__(self, *exc):
        self.gen_cls.generate = self.orig
        return False


class CollectCapture:
    """The inputs of the largest K17 call (by rows) of one run."""

    def __init__(self, taa):
        self.taa = taa
        self.big = None
        self.query = None

    def __enter__(self):
        orig = self.orig = self.taa.array_collect

        def rec(order, *args):
            if self.big is None or order.shape[0] > self.big[0]:
                self.big = (order.shape[0], self.query, (order,) + args)
            return orig(order, *args)
        self.taa.array_collect = rec
        return self

    def __exit__(self, *exc):
        self.taa.array_collect = self.orig
        return False


def result_columns(torch, np, res):
    """The live rows of a result as numpy arrays per field: a scalar
    field as (data, mask); an array field as ([W, n] data, [W, n] mask,
    lengths); a map field as (keys, key masks, values, value masks,
    lengths). Read from the batches, not through rows()."""
    out = {}
    for name, f in zip(res.names, res.fields):
        form = getattr(f, "form", None)
        syms = [f.symbol] if form is None else \
            [x.name for x in (list(getattr(form, "elements", ()))
                              + list(getattr(form, "keys", ()))
                              + list(getattr(form, "values", ())))]
        parts = {s: ([], []) for s in syms}
        lens = []
        for b in res.batches:
            live = b.row_valid
            for s in syms:
                c = b.columns[s]
                parts[s][0].append(c.data[live].cpu().numpy())
                parts[s][1].append(c.mask[live].cpu().numpy())
            if form is not None:
                lens.append(b.columns[form.length.name].data[live].cpu()
                            .numpy())
        cat = {s: (np.concatenate(d), np.concatenate(m))
               for s, (d, m) in parts.items()}
        if form is None:
            out[name] = cat[f.symbol]
            continue
        lens = np.concatenate(lens)
        if hasattr(form, "elements"):
            names = [x.name for x in form.elements]
            out[name] = (np.stack([cat[s][0] for s in names]),
                         np.stack([cat[s][1] for s in names]), lens)
        else:
            ks, vs = [x.name for x in form.keys], [x.name for x in form.values]
            out[name] = (np.stack([cat[s][0] for s in ks]),
                         np.stack([cat[s][1] for s in ks]),
                         np.stack([cat[s][0] for s in vs]),
                         np.stack([cat[s][1] for s in vs]), lens)
    return out


def collect_oracle(np, gid, ngroups, keep, values, width):
    """What array_agg collects per group in arrival order: [W, groups]
    values and masks (slot j of group g: the j-th row of g with `keep`),
    and the lengths. Rows are in arrival order."""
    perm = np.argsort(gid, kind="stable")   # groups, arrival order kept
    g, k = gid[perm], keep[perm].astype(np.int64)
    before = np.cumsum(k) - k
    rank = before - before[np.searchsorted(g, np.arange(ngroups))][g]
    lens = np.bincount(g, weights=k, minlength=ngroups).astype(np.int64)
    vals = np.zeros((width, ngroups), values.dtype)
    mask = np.zeros((width, ngroups), bool)
    sel = (k > 0) & (rank < width)
    vals[rank[sel], g[sel]] = values[perm][sel]
    mask[rank[sel], g[sel]] = True
    return vals, mask, lens


def check_collected(np, label, got, key, want_keys, want, field):
    """An array field against collect_oracle's (values, masks, lengths),
    rows matched by their group key (the result comes in no order):
    slot masks and lengths exactly, slot values where set."""
    kd, km = got[key]
    check(bool(km.all()), f"{label}: NULL group key")
    order = np.argsort(kd, kind="stable")
    check(np.array_equal(kd[order], want_keys),
          f"{label}: group keys differ from the oracle")
    vals, mask, lens = (x[..., order] for x in got[field])
    wv, wm, wl = want
    rows = wm.shape[0]
    check(np.array_equal(mask[:rows], wm) and not mask[rows:].any(),
          f"{label}: {field} slot masks differ")
    check(np.array_equal(vals[:rows][wm], wv[wm]),
          f"{label}: {field} slot values differ")
    check(np.array_equal(lens, wl), f"{label}: {field} lengths differ")


def array_oracle(np, gen_module, schema):
    """The numpy side of the array path: per query what its result must
    hold, from the connector's own generator."""
    gen = gen_module.TpchGenerator(gen_module.TpchConnector.SCHEMAS[schema])
    days = gen_module.parse_date_literal
    li = lineitem_table(np, gen, ("orderkey", "partkey", "quantity",
                                  "returnflag", "linenumber",
                                  "extendedprice", "shipdate", "suppkey",
                                  "linestatus", "shipmode", "shipinstruct",
                                  "tax", "discount"))
    orders = table(np, gen, "orders", ("orderkey", "custkey", "totalprice"))
    cust = table(np, gen, "customer", ("custkey", "acctbal", "nationkey"))
    rf = gen.schema("lineitem").column("returnflag").dictionary
    want = {"lineitem_rows": len(li["orderkey"])}
    okeys, ogid = np.unique(li["orderkey"], return_inverse=True)
    n_ord = len(okeys)
    want["arr_orders"] = (okeys, collect_oracle(
        np, ogid, n_ord, np.ones(len(ogid), bool), li["partkey"], 8),
        collect_oracle(np, ogid, n_ord, li["returnflag"] == rf.index("R"),
                       li["quantity"], 8))
    ckeys, cgid = np.unique(orders["custkey"], return_inverse=True)
    longest = int(np.bincount(cgid).max())
    want["arr_cust_longest"] = longest
    w = longest + 1
    want["arr_cust"] = (ckeys, collect_oracle(
        np, cgid, len(ckeys), np.ones(len(cgid), bool), orders["orderkey"], w),
        collect_oracle(np, cgid, len(ckeys), np.ones(len(cgid), bool),
                       orders["totalprice"], w))
    sel = li["shipdate"] >= days("1995-01-01")
    mkeys, mgid = np.unique(li["orderkey"][sel], return_inverse=True)
    want["map_lines"] = (mkeys, collect_oracle(
        np, mgid, len(mkeys), np.ones(len(mgid), bool),
        li["linenumber"][sel], 8), collect_oracle(
        np, mgid, len(mkeys), np.ones(len(mgid), bool),
        li["extendedprice"][sel], 8))
    want["unnest_back"] = [(len(li["partkey"]), int(li["partkey"].sum()))]
    want["ctas_arr"] = (okeys, np.bincount(ogid).astype(np.int64),
                        want["unnest_back"])
    g = li["orderkey"] < 240000
    gk = np.stack([li["orderkey"][g] % 1000, li["linenumber"][g],
                   li["partkey"][g] % 7, li["returnflag"][g],
                   li["linestatus"][g], li["shipmode"][g],
                   li["shipinstruct"][g],
                   np.round(li["tax"][g] * 100).astype(np.int64),
                   np.round(li["discount"][g] * 100).astype(np.int64)], 1)
    uk, inv, cnt = np.unique(gk, axis=0, return_inverse=True,
                             return_counts=True)
    inv = inv.reshape(-1)
    want["c6_group9"] = (uk, cnt, np.bincount(
        inv, weights=li["extendedprice"][g]))
    j = li["orderkey"] < 600000
    want["c6_join9"] = [(int(j.sum()), float(li["extendedprice"][j].sum()))]
    d = cust["nationkey"] % 3
    scale = 10.0 ** d.astype(np.float64)
    want["c7_round"] = (cust["custkey"],
                        np.round(cust["acctbal"].astype(np.float64) * scale)
                        / scale)
    return want, n_ord, len(ckeys), longest


def check_array_result(np, torch, label, res, want):
    """One query of the array path against its oracle (the big results
    read from the batches as numpy)."""
    if label in ("unnest_back", "c6_join9"):
        rows = res.rows()
        check(rows_match(rows, want[label]),
              f"{label}: {rows} != oracle {want[label]}")
        return
    got = result_columns(torch, np, res)
    if label == "arr_orders":
        keys, p, rq = want[label]
        check_collected(np, label, got, "orderkey", keys, p, "p")
        check_collected(np, label, got, "orderkey", keys, rq, "rq")
    elif label == "arr_cust":
        check(bool(np.all(np.diff(got["custkey"][0]) > 0)),
              f"{label}: rows not in custkey order")
        keys, o, t = want[label]
        check_collected(np, label, got, "custkey", keys, o, "o")
        check_collected(np, label, got, "custkey", keys, t, "t")
    elif label == "map_lines":
        keys, mk, mv = want[label]
        kd, km = got["orderkey"]
        order = np.argsort(kd, kind="stable")
        check(np.array_equal(kd[order], keys), f"{label}: keys differ")
        gk, gkm, gv, gvm, lens = got["m"]
        check(np.array_equal(lens[order], mk[2]), f"{label}: lengths differ")
        rows = mk[0].shape[0]
        for gd, gm, (wd, wm, _) in ((gk, gkm, mk), (gv, gvm, mv)):
            gd, gm = gd[:, order], gm[:, order]
            check(np.array_equal(gm[:rows], wm) and not gm[rows:].any(),
                  f"{label}: map slot masks differ")
            check(np.array_equal(gd[:rows][wm], wd[wm]),
                  f"{label}: map slot values differ")
    elif label == "c6_group9":
        uk, cnt, sums = want[label]
        cols = [got[n][0] for n in res.names[:9]]
        cols[7] = np.round(cols[7] * 100).astype(np.int64)
        cols[8] = np.round(cols[8] * 100).astype(np.int64)
        gk = np.stack([c.astype(np.int64) for c in cols], 1)
        order = np.lexsort(gk.T[::-1])
        check(np.array_equal(gk[order], uk), f"{label}: groups differ")
        check(np.array_equal(got["c"][0][order], cnt),
              f"{label}: counts differ")
        check(bool(np.allclose(got["s"][0][order], sums, rtol=1e-6,
                               atol=0)), f"{label}: sums differ")
    elif label == "c7_round":
        keys, vals = want[label]
        kd, _ = got["custkey"]
        order = np.argsort(kd, kind="stable")
        check(np.array_equal(kd[order], keys), f"{label}: keys differ")
        check(bool(np.allclose(got["r"][0][order], vals, rtol=1e-6,
                               atol=0)), f"{label}: values differ")


def run_ctas(runner, want, np, torch):
    """CTAS_ARR's statements in turn; returns the stored table's
    cardinalities and the unnest over it, checked against the oracle."""
    keys, lens, unnest_rows = want["ctas_arr"]
    res = [runner.execute(sql) for sql in CTAS_ARR]
    check(res[0].rows() == [(f"CREATE TABLE: {len(keys)} rows",)],
          f"ctas_arr: {res[0].rows()}")
    got = result_columns(torch, np, res[1])
    order = np.argsort(got["orderkey"][0], kind="stable")
    check(np.array_equal(got["orderkey"][0][order], keys)
          and np.array_equal(got["c"][0][order], lens),
          "ctas_arr: cardinalities of the stored arrays differ")
    check(rows_match(res[2].rows(), unnest_rows),
          f"ctas_arr: unnest of the stored table {res[2].rows()}")
    check(res[3].rows() == [("DROP TABLE",)], "ctas_arr: drop")
    return res


def measure_k17(torch, taa, args):
    """K17 at its largest call against collect_plain on the same CUDA
    inputs, both timed; the bound is the bytes it must move: order and
    pid, each spec's value, mask, FILTER and map-value columns read
    once, the blocks, masks, lengths and first rows written once."""
    order, pid, nlive, groups, specs, width, out_rows = args
    got = taa.array_collect(*args)
    want = taa.collect_plain(*args)
    torch.cuda.synchronize()
    (gouts, gfirst, gover), (wouts, wfirst, wover) = got, want
    check(bool(gover) == bool(wover) and torch.equal(gfirst, wfirst),
          "K17 array_collect: overflow or first rows differ")
    max_abs = 0.0
    moved = nbytes(order, pid) + nbytes(gfirst)
    for go, wo, (val, mval, filt) in zip(gouts, wouts, specs):
        check(torch.equal(go[4], wo[4]), "K17 array_collect: lengths differ")
        for g, w in zip(go[:4], wo[:4]):
            if g is None:
                continue
            same = torch.equal(g, w) if not g.is_floating_point() else \
                bool(((g == w) | (torch.isnan(g) & torch.isnan(w))).all())
            check(same, "K17 array_collect: blocks differ")
            moved += nbytes(g)
        moved += nbytes(go[4]) + sum(nbytes(*c) for c in (val, mval, filt)
                                     if c is not None)
    ms = time_ms(lambda: taa.array_collect(*args), torch)
    plain_ms = time_ms(lambda: taa.collect_plain(*args), torch)
    return {"rows": order.shape[0], "groups": groups, "out_rows": out_rows,
            "width": width, "specs": len(specs), "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def run_array_phases(torch, np, mods, dev, schema):
    """The array path: ARRAY_QUERIES at `schema` through LocalRunner,
    each against its numpy oracle, with cold and warm walls, the
    datagen share, the peak device memory and every kernel's launches
    per query; every new K12 kernel held against its composed form; K17
    at its largest call against collect_plain. Returns (K17's
    measurement, {kernel: launches on this path})."""
    tk, cg, ff, taa = mods["tk"], mods["codegen"], mods["ff"], mods["taa"]
    t = time.perf_counter()
    want, n_orders, n_cust, longest = array_oracle(np, mods["gen"], schema)
    emit({"phase": "array_oracle", "seconds": time.perf_counter() - t,
          "groups": {"arr_orders": n_orders, "arr_cust": n_cust},
          "arr_cust_longest_array": longest})
    runner = mods["LocalRunner"]("tpch", schema, properties=PROPS, device=dev)
    counters = list(tk.COUNTERS.values())
    launched_before = set(cg.LAUNCHED)
    composed_on_card = []
    compose = ff.compose_chain

    def counting_compose(stages, batch):
        if batch.device.type != "cpu":
            composed_on_card.append(len(stages))
        return compose(stages, batch)

    def run(label, sql):
        if label == "ctas_arr":
            return run_ctas(runner, want, np, torch)[1]
        return runner.execute(sql)
    launches, lines = {}, {}
    ff.compose_chain = counting_compose
    try:
        for label, sql in ARRAY_QUERIES.items():
            for c in counters:
                c.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            res = run(label, sql)
            if label != "ctas_arr":
                check_array_result(np, torch, label, res, want)
            cold = time.perf_counter() - t
            launches[label] = {c.name: c.launches for c in counters}
            peak = torch.cuda.max_memory_allocated()
            for k in ARRAY_MUST[label]:
                check(launches[label][k] > 0,
                      f"{k} was not launched in {label}")
            width = None
            if label == "arr_cust":
                width = len(res.fields[1].form.elements)
                check(width > longest, "arr_cust: width below the longest")
            warm, shares = [], []
            for _ in range(ARRAY_WARM):
                with DatagenTimer(mods["gen"].TpchGenerator) as dg:
                    t = time.perf_counter()
                    r = run(label, sql)
                    if label != "ctas_arr":
                        r.rows() if label in ("unnest_back", "c6_join9",
                                              "c7_round") \
                            else result_columns(torch, np, r)
                    warm.append(time.perf_counter() - t)
                shares.append(dg.seconds / warm[-1])
            i = sorted(range(len(warm)), key=warm.__getitem__)[len(warm) // 2]
            lines[label] = {
                "phase": "array", "query": label, "schema": schema,
                "batch_rows": PROPS["batch_rows"], "matches_oracle": True,
                "launches": launches[label],
                "k17_launches": launches[label]["array_collect"],
                "peak_device_bytes": peak, "cold_s": cold,
                "warm_s": warm[i], "warm_datagen_share": shares[i],
                **({"array_agg_width": width,
                    "width_retry": width != 64} if width else {})}
            emit(lines[label])
    finally:
        ff.compose_chain = compose
    check(not composed_on_card, "a filter/project chain ran its composed "
          f"form on the card {len(composed_on_card)} times")
    for label in ("arr_orders", "arr_cust"):
        emit({"phase": "profile", "query": label,
              **profile_query(torch, mods["gen"], runner,
                              ARRAY_QUERIES[label],
                              read=lambda r: result_columns(torch, np, r))})
    # K17 at its largest call, and every K12 kernel of this path
    cg.CAPTURE = {}
    k12_query = {}
    try:
        with CollectCapture(taa) as cap:
            for label in ("arr_orders", "arr_cust", "map_lines"):
                cap.query = label
                seen = {fp: id(v[2]) for fp, v in cg.CAPTURE.items()}
                runner.execute(ARRAY_QUERIES[label])
                for fp, v in cg.CAPTURE.items():
                    if seen.get(fp) != id(v[2]):
                        k12_query[fp] = label
            for label in ("c6_group9", "c6_join9", "c7_round",
                          "unnest_back"):
                seen = {fp: id(v[2]) for fp, v in cg.CAPTURE.items()}
                runner.execute(ARRAY_QUERIES[label]).rows()
                for fp, v in cg.CAPTURE.items():
                    if seen.get(fp) != id(v[2]):
                        k12_query[fp] = label
        k12_calls = cg.CAPTURE
    finally:
        cg.CAPTURE = None
    check(cap.big is not None, "K17's inputs were not captured")
    compared = {fp: measure_k12(torch, ff, kern, batch,
                                k12_query.get(fp, "?"))
                for fp, (_, kern, batch) in k12_calls.items()}
    new = set(cg.LAUNCHED) - launched_before
    check(new <= set(compared), f"{len(new - set(compared))} generated "
          "kernels of the array path were not held against their "
          "composed form")
    emit({"phase": "k12_compare", "path": "array", "kernels": len(compared),
          "new_first_launches": len(new),
          "values_compared": sum(m["values_compared"]
                                 for m in compared.values())})
    m = measure_k17(torch, taa, cap.big[2])
    emit({"phase": "kernels", "kernel": "array_collect",
          "family": "array_agg", "shape_from": cap.big[1], **m,
          "launches": {label: launches[label]["array_collect"]
                       for label in ARRAY_QUERIES}})
    totals = {name: sum(launches[label][name] for label in ARRAY_QUERIES)
              for name in tk.COUNTERS}
    return m, totals


# -- the sort family: ORDER BY, TopN, LIMIT (K24-K27) ------------------------

#: the sort family's largest call: every lineitem in three-key order
ORDER_LINES = """select orderkey, linenumber, extendedprice from lineitem
order by extendedprice desc, orderkey, linenumber"""
#: the same ORDER BY as a TopN: one topn step per 1,048,576-row batch
TOPN_LINES = ORDER_LINES + "\nlimit 100"
#: a bare LIMIT over five batches: K27 carries the emitted count
LIMIT_SCAN = """select count(*) from (select orderkey from lineitem
limit 5000000)"""
SORT_QUERIES = {"order_lines": ORDER_LINES, "topn_lines": TOPN_LINES,
                "limit_scan": LIMIT_SCAN}
SORT_MUST = {"order_lines": ("sort_encode", "radix_sort", "gather_rows"),
             "topn_lines": ("sort_encode", "radix_sort", "gather_rows"),
             "limit_scan": ("limit_rank",)}
LIMIT_SCAN_ROWS = 5_000_000
TOPN_ROWS = 100


def _cumsum_mask(torch, batch, n, emitted):
    valid = batch.row_valid
    return lambda: torch.cumsum(valid, 0)


#: the family-level forms timed on this path: label -> (family, the
#: function in ops/sort.py, its library yardstick: one stable torch.sort
#: of the leading key, torch.topk of the leading key of state ++ batch
#: (neither orders by the other keys or NULLs), the mask's cumsum)
SORT_FAMILIES = {"sort sort_batch": ("sort", "sort_batch", _sort_leading),
                 "topn topn_step": ("topn", "topn_step", _topk_leading),
                 "limit limit_batch": ("limit", "limit_batch", _cumsum_mask)}


def sort_oracle(np, gen_module, schema):
    """The lineitem columns ORDER_LINES reads and their order under its
    ORDER BY (np.lexsort: extendedprice descending, then orderkey, then
    linenumber, which leaves no ties)."""
    gen = gen_module.TpchGenerator(gen_module.TpchConnector.SCHEMAS[schema])
    li = lineitem_table(np, gen, ("orderkey", "linenumber", "extendedprice"))
    order = np.lexsort((li["linenumber"], li["orderkey"],
                        -li["extendedprice"]))
    return li, order


def check_sort_result(np, label, cols, li, order):
    if label == "limit_scan":
        data, mask = next(iter(cols.values()))
        check(len(data) == 1 and bool(mask[0])
              and int(data[0]) == LIMIT_SCAN_ROWS,
              f"limit_scan counted {data.tolist()}, not {LIMIT_SCAN_ROWS}")
        return
    take = order if label == "order_lines" else order[:TOPN_ROWS]
    for c in ("orderkey", "linenumber", "extendedprice"):
        data, mask = cols[c]
        want = li[c][take]
        check(len(data) == len(want) and bool(mask.all()),
              f"{label}: {len(data)} rows of {c}, {len(want)} expected")
        same = np.allclose(data, want, rtol=1e-6, atol=0) \
            if c == "extendedprice" else np.array_equal(
                data.astype(np.int64), want.astype(np.int64))
        if not same:
            bad = int(np.argmax(data != want))
            check(False, f"{label}: {c} differs from the oracle at row "
                  f"{bad}: {data[bad]} vs {want[bad]}")


class SortCapture(Patches):
    """Keeps the inputs of the largest call of K24-K27 and of the sort
    family's functions during one run of the sort queries (references:
    their inputs are not written after the call)."""

    def __init__(self, mods):
        super().__init__()
        self.m = mods
        self.big = {}
        self.query = None

    def _wrap(self, mod, attr, rows_fn):
        def make(orig):
            def rec(*args, **kw):
                rows = rows_fn(*args, **kw)
                if rows > self.big.get(attr, (0,))[0]:
                    self.big[attr] = (rows, self.query, args, kw)
                return orig(*args, **kw)
            return rec
        self._patch(mod, attr, make)

    def __enter__(self):
        tc, tsort = self.m["tc"], self.m["sort"]
        self._wrap(tc, "sort_encode", lambda parts, *a, **k: sum(
            (v if v is not None else c[0][0]).shape[0] for c, v in parts))
        self._wrap(tc, "radix_sort", lambda words, *a, **k:
                   tc._word_list(words)[0].shape[0])
        self._wrap(tc, "gather_rows", lambda parts, perm, *a, **k:
                   perm.shape[0])
        self._wrap(tsort, "limit_rank", lambda valid, *a: valid.shape[0])
        self._wrap(tsort, "sort_batch", lambda b, *a: b.capacity)
        self._wrap(tsort, "topn_step", lambda st, b, *a:
                   st.capacity + b.capacity)
        self._wrap(tsort, "limit_batch", lambda b, *a: b.capacity)
        return self


class PlainSort(Patches):
    """Inside: K24-K27's wrappers are their plain versions (the yardstick
    of a sort-family function: the same function, plain steps)."""

    def __init__(self, mods):
        super().__init__()
        self.m = mods

    def __enter__(self):
        tc, tsort = self.m["tc"], self.m["sort"]
        for mod, attr in ((tc, "sort_encode"), (tc, "radix_sort"),
                          (tc, "gather_rows"), (tsort, "limit_rank")):
            plain = getattr(mod, attr + "_plain")
            self._patch(mod, attr, lambda orig, plain=plain: plain)
        return self


def _parts_bytes(parts) -> int:
    return sum(nbytes(d) + (0 if m is None else nbytes(m))
               for cols, _ in parts for d, m in cols) \
        + sum(nbytes(v) for _, v in parts if v is not None)


def measure_sort_encode(torch, tc, args, kw):
    got = tc.sort_encode(*args, **kw)
    want = tc.sort_encode_plain(*args, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "K24 sort_encode: words or digit masks differ from its plain "
          "version")
    ms = time_ms(lambda: tc.sort_encode(*args, **kw), torch)
    plain_ms = time_ms(lambda: tc.sort_encode_plain(*args, **kw), torch)
    words, digits = got
    # keys, masks and row_valid read once; the words and masks written
    moved = _parts_bytes(args[0]) + nbytes(words, digits)
    return {"rows": words.shape[1], "keys": len(args[0][0][0]),
            "sources": len(args[0]), "words": words.shape[0],
            "varying_digits": [int(x) for x in digits.tolist()],
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_radix_sort(torch, tc, args, kw):
    got = tc.radix_sort(*args, **kw)
    want = tc.radix_sort_plain(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and (
        got[1] is None) == (want[1] is None) and (
            got[1] is None or torch.equal(got[1], want[1])),
          "K25 radix_sort: the permutation or the sorted words differ from "
          "its plain version")
    ms = time_ms(lambda: tc.radix_sort(*args, **kw), torch)
    plain_ms = time_ms(lambda: tc.radix_sort_plain(*args, **kw), torch)
    wl = tc._word_list(args[0])
    flip = kw.get("flip", False)
    # one stable torch.sort of the leading word (signed order; the only
    # word at a join build)
    lead = wl[0] if flip else wl[0] ^ torch.iinfo(torch.int64).min
    library_ms = time_ms(lambda: torch.sort(lead, stable=True), torch)
    digits = args[1] if len(args) > 1 else kw.get("digits")
    masks = [0xFF] * len(wl) if digits is None else digits.tolist()
    n = wl[0].shape[0]
    # every key word read once; the permutation (and the sorted word 0)
    # written once
    moved = 8 * n * len(wl) + 8 * n * (2 if kw.get("sorted_first") else 1)
    return {"rows": n, "words": len(wl),
            "passes": len(tc.radix_passes(masks)),
            "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_gather_rows(torch, tc, args, kw):
    parts, perm = args[0], args[1]
    got = tc.gather_rows(*args, **kw)
    want = tc.gather_rows_plain(*args, **kw)
    torch.cuda.synchronize()
    same = (got[1] is None) == (want[1] is None) and (
        got[1] is None or torch.equal(got[1], want[1]))
    for (gd, gm), (wd, wm) in zip(got[0], want[0]):
        same = same and torch.equal(gd, wd) if not gd.is_floating_point() \
            else same and torch.equal(gd.view(torch.uint8),
                                      wd.view(torch.uint8))
        same = same and ((gm is None and wm is None) or torch.equal(gm, wm))
    check(same, "K26 gather_rows differs from its plain version")
    ms = time_ms(lambda: tc.gather_rows(*args, **kw), torch)
    plain_ms = time_ms(lambda: tc.gather_rows_plain(*args, **kw), torch)
    rows = got[0][0][0].shape[0] if got[0] else perm.shape[0]
    library_ms = None
    if len(parts) == 1:
        p = perm[:rows]
        arrays = [t for d, m in parts[0][0] for t in (d, m) if t is not None]
        if parts[0][1] is not None:
            arrays.append(parts[0][1])
        library_ms = time_ms(lambda: [t.index_select(0, p) for t in arrays],
                             torch)
    # the permutation's rows read once; every output element written
    # once and its input element read once
    out_bytes = sum(nbytes(d) + (0 if m is None else nbytes(m))
                    for d, m in got[0]) + (0 if got[1] is None
                                           else nbytes(got[1]))
    moved = 8 * rows + 2 * out_bytes
    return {"rows": rows, "arrays": sum(1 + (m is not None)
                                        for d, m in got[0])
            + (got[1] is not None), "sources": len(parts),
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_limit_rank(torch, tsort, args, kw):
    valid, n, emitted = args
    got = tsort.limit_rank(*args)
    want = tsort.limit_rank_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and int(got[1]) == int(want[1]),
          "K27 limit_rank differs from its plain version")
    ms = time_ms(lambda: tsort.limit_rank(*args), torch)
    plain_ms = time_ms(lambda: tsort.limit_rank_plain(*args), torch)
    library_ms = time_ms(lambda: torch.cumsum(valid, 0), torch)
    rows = valid.shape[0]
    # row_valid read once, keep written once, the two counts
    moved = 2 * rows + 16
    return {"rows": rows, "live": int(valid.sum()), "limit": int(n),
            "emitted_before": int(emitted), "kept": int(want[0].sum()),
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_sort_family(torch, mods, label, args):
    """A sort-family function at its largest call: its time (K24-K27),
    the same function with the kernels' plain versions, the library
    yardstick, and the bytes its arguments and new outputs hold."""
    _, fn_name, library = SORT_FAMILIES[label]
    fn = getattr(mods["sort"], fn_name)
    m = measure_composed(torch, fn, args)
    with PlainSort(mods):
        m["plain_ms"] = time_ms(lambda: fn(*args), torch)
    m["library_ms"] = time_ms(library(torch, *args), torch)
    return m


def run_sort_phases(torch, np, mods, dev, schema):
    """The sort path: SORT_QUERIES at `schema` through LocalRunner, each
    against the numpy oracle, with cold and warm walls, every kernel's
    launches and a profile of one warm execution; K24-K27 at their
    largest calls against their plain
    versions, and sort_batch, topn_step and limit_batch against the same
    functions through the plain versions. Returns ({kernel:
    measurement}, {kernel: launches on this path})."""
    tk = mods["tk"]
    t = time.perf_counter()
    li, order = sort_oracle(np, mods["gen"], schema)
    emit({"phase": "sort_oracle", "seconds": time.perf_counter() - t,
          "lineitem_rows": len(order)})
    runner = mods["LocalRunner"]("tpch", schema, properties=PROPS,
                                 device=dev)
    counters = list(tk.COUNTERS.values())
    launches, calls = {}, {}
    for label, sql in SORT_QUERIES.items():
        for c in counters:
            c.launches = 0
        before = dict(tk.CALLS)
        t = time.perf_counter()
        cols = result_columns(torch, np, runner.execute(sql))
        cold = time.perf_counter() - t
        launches[label] = {c.name: c.launches for c in counters}
        calls[label] = {f: n - before.get(f, 0) for f, n in tk.CALLS.items()
                        if n - before.get(f, 0)}
        check_sort_result(np, label, cols, li, order)
        for k in SORT_MUST[label]:
            check(launches[label][k] > 0, f"{k} was not launched in {label}")
        t = time.perf_counter()
        result_columns(torch, np, runner.execute(sql))
        warm = time.perf_counter() - t
        emit({"phase": "sort", "query": label, "schema": schema,
              "batch_rows": PROPS["batch_rows"],
              "rows": len(next(iter(cols.values()))[0]),
              "matches_oracle": True, "launches": launches[label],
              "family_calls": calls[label], "cold_s": cold,
              "warm_s": warm,
              "lineitem_rows": len(order)})
    # where a warm query's time goes
    for label, sql in SORT_QUERIES.items():
        emit({"phase": "profile", "query": label,
              **profile_query(torch, mods["gen"], runner, sql,
                              read=lambda r: result_columns(torch, np, r))})
    with SortCapture(mods) as cap:
        for label, sql in SORT_QUERIES.items():
            cap.query = label
            result_columns(torch, np, runner.execute(sql))
    check(set(cap.big) == {"sort_encode", "radix_sort", "gather_rows",
                           "limit_rank", "sort_batch", "topn_step",
                           "limit_batch"},
          f"sort inputs were not captured: {sorted(cap.big)}")
    measure = {"sort_encode": measure_sort_encode,
               "radix_sort": measure_radix_sort,
               "gather_rows": measure_gather_rows}
    measured = {}
    for name in SORT_KERNELS:
        _, q, args, kw = cap.big[name]
        m = measure_limit_rank(torch, mods["sort"], args, kw) \
            if name == "limit_rank" else measure[name](torch, mods["tc"],
                                                       args, kw)
        measured[name] = m
        emit({"phase": "kernels", "kernel": name, "shape_from": q, **m,
              "launches": {label: launches[label][name]
                           for label in SORT_QUERIES}})
    for label, (family, fn_name, _) in SORT_FAMILIES.items():
        _, q, args, _ = cap.big[fn_name]
        # topn's step: the state's slots beside the batch's
        sizes = {"state_slots": args[0].capacity,
                 "batch_slots": args[1].capacity} \
            if fn_name == "topn_step" else {}
        emit({"phase": "kernels", "kernel": label, "family": family,
              "shape_from": q, **sizes,
              **measure_sort_family(torch, mods, label, args),
              "calls": {lbl: calls[lbl].get(family, 0)
                        for lbl in SORT_QUERIES}})
    totals = {name: sum(launches[label].get(name, 0)
                        for label in SORT_QUERIES)
              for name in tk.COUNTERS}
    return measured, totals


# -- the aggregation path: approx_percentile, approx_distinct, checksum -----

#: the direct path (dictionary keys: K1 + K30's direct mode, K29)
APPROX_DIRECT = """select returnflag, linestatus,
approx_percentile(extendedprice, 0.5), approx_distinct(partkey),
checksum(orderkey) from lineitem group by 1, 2"""
#: the sort path: 10,000 groups, per-batch partials shrunk (K28),
#: counted (the carried count), merged (K3 / K26 over the sources, K30's
#: dense mode) and drained (K29)
APPROX_GROUPED = """select suppkey, approx_percentile(quantity, 0.9),
approx_distinct(orderkey) from lineitem group by suppkey"""
#: a global aggregation: one slot of the direct path
APPROX_GLOBAL = "select approx_distinct(orderkey) from lineitem"
#: the streaming path: lineitem arrives sorted by orderkey, so K8 groups
#: each batch and K30 folds the vector states over K8's segments, the
#: order carried across a batch border folded into the next batch's
#: first group (1,500,000 groups)
APPROX_STREAM = """select orderkey, approx_percentile(extendedprice, 0.5),
approx_distinct(partkey), checksum(suppkey) from lineitem group by orderkey"""
#: the streaming query's batches: 262,144 rows, so each batch's vector
#: states ([out_cap, 1024] int32 and [out_cap, 2048] int8, every slot a
#: possible order) stay near 3 GB on the card
AGG_PROPS = {"approx_stream": {"batch_rows": 1 << 18}}
AGG_QUERIES = {"approx_direct": APPROX_DIRECT,
               "approx_grouped": APPROX_GROUPED,
               "approx_global": APPROX_GLOBAL,
               "approx_stream": APPROX_STREAM}
#: the kernels each query must launch (no filter or projection: no K12)
AGG_MUST = {"approx_direct": ("direct_slot_reduce", "vector_reduce",
                              "agg_finalize"),
            "approx_grouped": ("row_hash", "radix_sort", "gather_rows",
                               "segment_reduce", "vector_reduce",
                               "state_shrink", "row_hash_sources",
                               "gather_rows_sources", "agg_finalize"),
            "approx_global": ("direct_slot_reduce", "vector_reduce",
                              "agg_finalize"),
            "approx_stream": ("stream_reduce", "vector_reduce",
                              "agg_finalize")}
#: the sketches' geometry, as ops/hashagg.py (and the reference) has it
PCTL_BUCKETS, PCTL_GAMMA = 1024, 1.06
HLL_M = 2048  # hll_registers_for_error(0.023)


def np_hash64(np, x):
    """The reference's hash64 of present int64 values (splitmix64 in
    uint64), in numpy."""
    x = x.astype(np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def np_pctl_values(np):
    half, exp0 = PCTL_BUCKETS // 2, PCTL_BUCKETS // 4
    mags = PCTL_GAMMA ** (np.arange(half - 1).astype(np.float64) - exp0)
    out = np.zeros(PCTL_BUCKETS)
    out[half:2 * half - 1] = mags
    out[half - 2::-1] = -mags
    return out


def np_pctl(np, gid, groups, value, fraction):
    """The reference's approx_percentile per group, in numpy: the first
    bucket whose cumulative count reaches max(ceil(fraction * total),
    1), which is the bucket of that rank among the group's rows sorted
    by bucket (no [groups, buckets] histogram)."""
    half, exp0 = PCTL_BUCKETS // 2, PCTL_BUCKETS // 4
    mag = np.abs(value.astype(np.float64))
    li = np.clip(np.round(np.log(np.maximum(mag, 1e-12))
                          / float(np.log(PCTL_GAMMA))).astype(np.int32)
                 + exp0, 0, half - 2)
    b = np.where(value >= 0, half + li, half - 2 - li)
    b = np.where(mag < 1e-12, half - 1, b).astype(np.int64)
    total = np.bincount(gid, minlength=groups)
    starts = np.r_[0, np.cumsum(total)[:-1]]
    target = np.maximum(np.ceil(fraction * total.astype(np.float64)), 1.0)
    at = np.minimum(starts + target.astype(np.int64) - 1, len(b) - 1)
    return np_pctl_values(np)[b[np.lexsort((b, gid))][at]]


def np_hll(np, gid, groups, value):
    """The reference's approx_distinct per group (m = HLL_M), in numpy:
    register = the hash's low bits, the leading zeros of the rest plus
    one maxed into it (every register of a group with a row at least
    0), then the estimate with the linear-counting correction; over the
    touched registers only (no [groups, m] table)."""
    m = HLL_M
    b = int(np.log2(m))
    h = np_hash64(np, value)
    reg = (h & np.uint64(m - 1)).astype(np.int64)
    x = (h >> np.uint64(b)).astype(np.int64)
    bits = np.zeros_like(x)
    for sh in (32, 16, 8, 4, 2, 1):
        t = x >> sh
        big = t != 0
        bits += np.where(big, sh, 0)
        x = np.where(big, t, x)
    bits += (x != 0)
    rho = (65 - b) - bits
    key = (gid * m + reg) * 64 + rho
    key.sort()
    cell = key >> 6
    last = np.r_[cell[1:] != cell[:-1], True]
    # the touched registers only: an untouched one adds 2^0 and counts
    # as a zero (the dyadic sums are exact in any order)
    g = cell[last] // m
    touched = np.bincount(g, minlength=groups)
    alpha = 0.7213 / (1 + 1.079 / (1 << b))
    est = alpha * m * m / (np.bincount(
        g, weights=np.exp2(-(key[last] & 63).astype(np.float64)),
        minlength=groups) + (m - touched))
    zeros = (m - touched).astype(np.float64)
    small = m * np.log(m / np.maximum(zeros, 1.0))
    est = np.where((est <= 2.5 * m) & (zeros > 0), small, est)
    return np.round(est).astype(np.int64)


def np_checksum(np, gid, groups, value):
    h = np_hash64(np, value)
    out = np.zeros(groups, dtype=np.uint64)
    np.add.at(out, gid, h)
    return out.view(np.int64)


def agg_oracle(np, gen_module, schema):
    """The AGG_QUERIES in numpy: each sketch as the reference
    builds it (exactly), and the exact answers it approximates (sorted
    values' percentile, distinct counts)."""
    gen = gen_module.TpchGenerator(gen_module.TpchConnector.SCHEMAS[schema])
    li = lineitem_table(np, gen, ("returnflag", "linestatus",
                                  "extendedprice", "partkey", "orderkey",
                                  "suppkey", "quantity"))
    sch = gen.schema("lineitem")
    rf = sch.column("returnflag").dictionary
    ls = sch.column("linestatus").dictionary
    want, exact = {}, {}
    gid = li["returnflag"].astype(np.int64) * len(ls) \
        + li["linestatus"].astype(np.int64)
    used = np.unique(gid)
    ng = len(rf) * len(ls)
    p = np_pctl(np, gid, ng, li["extendedprice"], 0.5)
    d = np_hll(np, gid, ng, li["partkey"])
    c = np_checksum(np, gid, ng, li["orderkey"])
    want["approx_direct"] = sorted(
        (rf[g // len(ls)], ls[g % len(ls)], float(p[g]), int(d[g]), int(c[g]))
        for g in used)
    exact["approx_direct"] = {
        (rf[g // len(ls)], ls[g % len(ls)]): (
            _exact_pctl(np, li["extendedprice"][gid == g], 0.5),
            len(np.unique(li["partkey"][gid == g])))
        for g in used}
    supp, sgid = np.unique(li["suppkey"], return_inverse=True)
    p = np_pctl(np, sgid, len(supp), li["quantity"], 0.9)
    d = np_hll(np, sgid, len(supp), li["orderkey"])
    want["approx_grouped"] = sorted(
        (int(supp[g]), float(p[g]), int(d[g])) for g in range(len(supp)))
    order = np.lexsort((li["orderkey"], sgid))
    sg, so = sgid[order], li["orderkey"][order]
    first = np.r_[True, (sg[1:] != sg[:-1]) | (so[1:] != so[:-1])]
    distinct = np.bincount(sg[first], minlength=len(supp))
    qty = li["quantity"][np.argsort(sgid, kind="stable")]
    starts = np.r_[0, np.cumsum(np.bincount(sgid, minlength=len(supp)))]
    exact["approx_grouped"] = {
        int(supp[g]): (_exact_pctl(np, qty[starts[g]:starts[g + 1]], 0.9),
                       int(distinct[g])) for g in range(len(supp))}
    zero = np.zeros(len(li["orderkey"]), dtype=np.int64)
    want["approx_global"] = [(int(np_hll(np, zero, 1, li["orderkey"])[0]),)]
    exact["approx_global"] = {(): (None, len(np.unique(li["orderkey"])))}
    okeys, ogid = np.unique(li["orderkey"], return_inverse=True)
    ng = len(okeys)
    p = np_pctl(np, ogid, ng, li["extendedprice"], 0.5)
    d = np_hll(np, ogid, ng, li["partkey"])
    c = np_checksum(np, ogid, ng, li["suppkey"])
    want["approx_stream"] = sorted(zip(okeys.tolist(), p.tolist(),
                                       d.tolist(), c.tolist()))
    total = np.bincount(ogid, minlength=ng)
    starts = np.r_[0, np.cumsum(total)[:-1]]
    at = starts + np.maximum(np.ceil(0.5 * total), 1).astype(np.int64) - 1
    price = li["extendedprice"][np.lexsort((li["extendedprice"], ogid))]
    order = np.lexsort((li["partkey"], ogid))
    og, op = ogid[order], li["partkey"][order]
    first = np.r_[True, (og[1:] != og[:-1]) | (op[1:] != op[:-1])]
    exact["approx_stream"] = dict(zip(okeys.tolist(), zip(
        price[at].tolist(), np.bincount(og[first], minlength=ng).tolist())))
    return want, exact, len(li["orderkey"])


def _exact_pctl(np, values, fraction):
    """The value of rank max(ceil(fraction * n), 1) among the sorted
    values (what the sketch's bucket approximates)."""
    v = np.sort(values)
    return float(v[max(int(np.ceil(fraction * len(v))), 1) - 1])


def check_agg_result(label, got, want, exact) -> dict:
    """The rows equal the numpy sketch's exactly, and each estimate lies
    within its sketch's error of the exact answer: a percentile within
    one bucket's relative half-width (gamma^0.5 - 1), a distinct count
    within five standard errors (1.04 / sqrt(m)). Returns the largest
    relative errors seen."""
    check(sorted(got) == want,
          f"{label} differs from the numpy sketch: "
          f"{first_difference(sorted(got), want)}")
    pctl_tol = PCTL_GAMMA ** 0.5 - 1
    hll_tol = 5 * 1.04 / HLL_M ** 0.5
    worst = {"pctl_rel_err": 0.0, "distinct_rel_err": 0.0}
    for row in got:
        if label == "approx_global":
            key, pctl, dist = (), None, row[0]
        elif label == "approx_direct":
            key, pctl, dist = (row[0], row[1]), row[2], row[3]
        else:
            key, pctl, dist = row[0], row[1], row[2]
        ex_p, ex_d = exact[key]
        if pctl is not None:
            rel = abs(pctl / ex_p - 1)
            worst["pctl_rel_err"] = max(worst["pctl_rel_err"], rel)
        rel = abs(dist / ex_d - 1)
        worst["distinct_rel_err"] = max(worst["distinct_rel_err"], rel)
    check(worst["pctl_rel_err"] <= pctl_tol * (1 + 1e-9),
          f"{label}: a percentile is {worst['pctl_rel_err']:.4f} off the "
          f"exact one (tolerance {pctl_tol:.4f})")
    # an order's distinct parts (at most seven) lie below the range the
    # sketch's standard error describes: one register shared by two of
    # them is a miss of one; those counts are held to the numpy sketch
    # exactly (above) and their error reported
    check(label == "approx_stream"
          or worst["distinct_rel_err"] <= hll_tol,
          f"{label}: a distinct count is {worst['distinct_rel_err']:.4f} off "
          f"the exact one (tolerance {hll_tol:.4f})")
    return worst


class VectorCapture(Patches):
    """K30's largest call per mode (direct, sparse, stream, dense) during
    one run of the aggregation queries: the direct mode's table copied
    (it is updated in place), the others' inputs by reference."""

    def __init__(self, mods):
        super().__init__()
        self.m = mods
        self.big = {}  # mode -> (rows, query, args, kwargs)
        self.query = None

    def __enter__(self):
        ak = self.m["ak"]

        def direct(orig):
            def rec(row_valid, keys, domains, index, value, table, reduce,
                    slot_ids):
                n = row_valid.shape[0]
                if n > self.big.get("direct", (0,))[0]:
                    self.big["direct"] = (n, self.query, (
                        row_valid, keys, domains, index, value,
                        table.clone(), reduce, slot_ids), {})
                return orig(row_valid, keys, domains, index, value, table,
                            reduce, slot_ids)
            return rec

        def segments(orig):
            def rec(*args, **kw):
                mode = "dense" if kw.get("sparse") is None else \
                    "sparse" if kw.get("carry") is None else "stream"
                n = (sum(d.shape[0] for d in kw["dense"]) if mode == "dense"
                     else kw["sparse"][0].shape[0])
                if n > self.big.get(mode, (0,))[0]:
                    self.big[mode] = (n, self.query, args, kw)
                return orig(*args, **kw)
            return rec
        self._patch(ak, "vector_direct", direct)
        self._patch(ak, "vector_segments", segments)
        return self


def measure_k30(torch, ak, mode, args, kw):
    """K30 at its largest call of `mode` against its plain version:
    integer folds, so exactly. Bytes: the pairs (or the dense rows of
    the live positions, read through the permutation) read once, the
    output written once."""
    if mode == "direct":
        row_valid, keys, domains, index, value, table, reduce, slot_ids = args
        got, want = table.clone(), table.clone()
        ak.vector_direct(row_valid, keys, domains, index, value, got, reduce,
                         slot_ids)
        gid = slot_ids(row_valid, keys, domains, table.shape[0])
        ak.vector_direct_plain(gid, index, value, want, reduce)
        torch.cuda.synchronize()
        check(torch.equal(got, want), "K30 direct differs from its plain "
              "version")
        work = table.clone()
        ms = time_ms(lambda: ak.vector_direct(
            row_valid, keys, domains, index, value, work, reduce, slot_ids),
            torch)

        def plain():
            ak.vector_direct_plain(slot_ids(row_valid, keys, domains,
                                            table.shape[0]),
                                   index, value, work, reduce)
        plain_ms = time_ms(plain, torch)
        moved = nbytes(row_valid, index, value) \
            + sum(nbytes(c, m) for c, m in keys) + 2 * nbytes(table)
        lib = None
        if reduce == "sum":
            flat = (gid * table.shape[1] + index.to(torch.int64))
            tgt = torch.zeros(table.numel() + table.shape[1],
                              dtype=table.dtype, device=table.device)
            val = value.to(table.dtype)
            lib = time_ms(lambda: tgt.index_add_(0, flat, val), torch)
        return {"mode": mode, "rows": row_valid.shape[0],
                "table": list(table.shape), "max_abs_err": 0.0, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib,
                "bound_ms": _bound(moved)}
    _, valid, out_cap, K, dtype, _ = args
    cy = kw.get("carry")
    pkw = kw
    if cy is not None:
        # the new carry of each in its own tensor
        kw = {**kw, "carry": ak.Carry(cy.row, cy.same, torch.empty_like(
            cy.out))}
        pkw = {**kw, "carry": ak.Carry(cy.row, cy.same, torch.empty_like(
            cy.out))}
    got = ak.vector_segments(*args, **kw)
    want = ak.vector_segments_plain(*args, **pkw)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and (cy is None or torch.equal(
        kw["carry"].out, pkw["carry"].out)),
          f"K30 {mode} differs from its plain version")
    ms = time_ms(lambda: ak.vector_segments(*args, **kw), torch)
    plain_ms = time_ms(lambda: ak.vector_segments_plain(*args, **pkw),
                       torch)
    pairs = mode in ("sparse", "stream")
    nlive = int(valid.sum()) if valid is not None else (
        kw["sparse"][0].shape[0] if pairs
        else sum(d.shape[0] for d in kw["dense"]))
    elem = torch.empty((), dtype=dtype).element_size()
    if pairs:
        read = nlive * (4 + elem)
    else:
        read = nlive * K * elem + (nbytes(kw["perm"]) if kw.get("perm")
                                   is not None else 0)
    # the carried row read and the new one written
    moved = read + (0 if valid is None else nbytes(valid)) \
        + out_cap * K * elem + (0 if cy is None else 2 * K * elem)
    return {"mode": mode, "rows": nlive, "out": [out_cap, K],
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": _bound(moved)}


def run_agg_phases(torch, np, mods, dev, schema):
    """The aggregation path: AGG_QUERIES at `schema` through LocalRunner,
    each against the numpy sketches exactly and the exact answers within
    the sketches' errors, with cold and warm walls, peak device memory
    and every kernel's launches; K30 at its largest call of each mode
    against its plain version. Returns ({kernel: measurement}, {kernel:
    launches on this path})."""
    tk = mods["tk"]
    t = time.perf_counter()
    want, exact, n_lineitem = agg_oracle(np, mods["gen"], schema)
    emit({"phase": "agg_oracle", "seconds": time.perf_counter() - t,
          "lineitem_rows": n_lineitem})
    runners = {label: mods["LocalRunner"](
        "tpch", schema, properties=AGG_PROPS.get(label, PROPS), device=dev)
        for label in AGG_QUERIES}
    counters = list(tk.COUNTERS.values())
    launches = {}
    for label, sql in AGG_QUERIES.items():
        for c in counters:
            c.launches = 0
        before = dict(tk.CALLS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        runner = runners[label]
        rows = runner.execute(sql).rows()
        cold = time.perf_counter() - t
        launches[label] = {c.name: c.launches for c in counters}
        calls = {f: n - before.get(f, 0) for f, n in tk.CALLS.items()
                 if n - before.get(f, 0)}
        peak = torch.cuda.max_memory_allocated()
        worst = check_agg_result(label, rows, want[label], exact[label])
        for k in AGG_MUST[label]:
            check(launches[label][k] > 0, f"{k} was not launched in {label}")
        t = time.perf_counter()
        again = runner.execute(sql).rows()
        warm = time.perf_counter() - t
        check(sorted(again) == want[label], f"{label}'s warm run differs")
        emit({"phase": "agg", "query": label, "schema": schema,
              "batch_rows": AGG_PROPS.get(label, PROPS)["batch_rows"],
              "rows": rows if len(rows) <= 20 else len(rows),
              "matches_sketch_oracle": True, **worst,
              "launches": launches[label], "family_calls": calls,
              "cold_s": cold, "warm_s": warm, "peak_device_bytes": peak,
              "lineitem_rows": n_lineitem,
              "warm_lineitem_rows_per_s": n_lineitem / warm})
    for label, sql in AGG_QUERIES.items():
        emit({"phase": "profile", "query": label,
              **profile_query(torch, mods["gen"], runners[label], sql)})
    with VectorCapture(mods) as cap:
        for label, sql in AGG_QUERIES.items():
            cap.query = label
            runners[label].execute(sql).rows()
    check(set(cap.big) == {"direct", "sparse", "stream", "dense"},
          f"K30's inputs were not captured: {sorted(cap.big)}")
    measured = {}
    for mode in ("direct", "sparse", "stream", "dense"):
        _, q, args, kw = cap.big[mode]
        m = measure_k30(torch, mods["ak"], mode, args, kw)
        emit({"phase": "kernels", "kernel": "vector_reduce",
              "shape_from": q, **m})
        measured[mode] = m
    totals = {name: sum(launches[label].get(name, 0)
                        for label in AGG_QUERIES)
              for name in tk.COUNTERS}
    # K30's summary figures: its largest merge (the dense mode)
    return {"vector_reduce": measured["dense"]}, totals


# -- the mesh path (K18, K19) ----------------------------------------------

#: the wave collision query of the reference's mesh tests
#: (tests/test_mesh_parity.py:33-38): all-integer rows, nationkey 0 a
#: real join key, and a FilterProject tail the wave absorbs
COLLISION = """SELECT n.nationkey, count(*) AS c
FROM supplier s, nation n
WHERE s.nationkey = n.nationkey AND s.suppkey >= 0
GROUP BY n.nationkey ORDER BY n.nationkey"""

#: a distributed ORDER BY of every order: 1,500,000 rows, one sorted run
#: per task, merged by the MergeNode (K19)
MESH_ORDER = """SELECT orderkey, custkey, totalprice FROM orders
ORDER BY totalprice DESC, orderkey"""

MESH_QUERIES = {"q1": Q1, "q3": Q3, "q5": Q5, "q6": Q6, "q18": Q18,
                "q4": Q4, "collision": COLLISION, "mesh_order": MESH_ORDER}
#: the mesh runner: eight logical workers on one card, every join
#: repartitioned through the wave
MESH_PROPS = {**PROPS, "broadcast_join_threshold_rows": 0}
MESH_WORKERS = 8
#: the kernels each mesh query must launch (Q6's single aggregate needs
#: only a gather; MESH_ORDER only a gather and the merge)
MESH_MUST = {"q1": ("exchange_shuffle", "fragment"),
             "q3": ("exchange_shuffle", "fragment"),
             "q5": ("exchange_shuffle", "fragment"),
             "q6": ("fragment",),
             "q18": ("exchange_shuffle", "fragment"),
             "q4": ("exchange_shuffle", "fragment"),
             "collision": ("exchange_shuffle", "fragment"),
             "mesh_order": ("merge_pair",)}


def mesh_oracle(np, gen_module, schema):
    """COLLISION and MESH_ORDER in numpy over the generated tables:
    suppliers counted per nation; every order sorted by totalprice
    descending, then orderkey."""
    gen = gen_module.TpchGenerator(gen_module.TpchConnector.SCHEMAS[schema])
    sup = table(np, gen, "supplier", ("suppkey", "nationkey"))
    nation = table(np, gen, "nation", ("nationkey",))
    keep = np.isin(sup["nationkey"], nation["nationkey"]) \
        & (sup["suppkey"] >= 0)
    counts = np.bincount(sup["nationkey"][keep])
    collision = [(int(k), int(c)) for k, c in enumerate(counts) if c]
    o = table(np, gen, "orders", ("orderkey", "custkey", "totalprice"))
    order = np.lexsort((o["orderkey"], -o["totalprice"]))
    return collision, {c: o[c][order]
                       for c in ("orderkey", "custkey", "totalprice")}


class ArgCapture:
    """The arguments of the largest call (by `size(args)`) of one module
    function while active, calling through."""

    def __init__(self, module, name, size):
        self.module, self.name, self.size = module, name, size
        self.big = None
        self.query = None

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def rec(*args):
            n = self.size(args)
            if self.big is None or n > self.big[0]:
                self.big = (n, self.query, args)
            return orig(*args)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


def _wave_rows(args):
    return sum(p[1].shape[0] for p in args[0] if p is not None)


def _same_tensor(torch, a, b) -> bool:
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


#: K18's kernels, in launch order (csrc/exchange_shuffle.cu)
K18_LAUNCHES = ("wave_count", "wave_scan", "wave_scatter", "wave_pad")


def measure_k18(torch, tsh, args):
    """K18 at the largest wave against its plain version on the same
    CUDA inputs (exactly: every consumer's columns, masks, row_valid and
    count, in order), both timed. The byte bound: every producer slot's
    row_valid read once, the hash, data and mask of each live producer
    row read once (a dead row is never read), every consumer batch
    written once."""
    producers, w, shard_len, template = args
    got, gcounts = tsh.wave_shuffle(*args)
    want, wcounts = tsh.wave_shuffle_plain(*args)
    torch.cuda.synchronize()
    check(list(gcounts) == list(wcounts), "K18 exchange_shuffle: counts "
          f"differ: {gcounts} vs {wcounts}")
    moved = 0
    for (gc, gv), (wc, wv) in zip(got, want):
        check(torch.equal(gv, wv), "K18 exchange_shuffle: row_valid differs")
        for (gd, gm), (wd, wm) in zip(gc, wc):
            check(_same_tensor(torch, gd, wd) and torch.equal(gm, wm),
                  "K18 exchange_shuffle: a consumer column differs")
            moved += nbytes(gd, gm)
        moved += nbytes(gv)
    for p in producers:
        if p is not None:
            live = int(p[1].sum())
            moved += nbytes(p[1]) + live * (
                p[0].element_size()
                + sum(d.element_size() + m.element_size() for d, m in p[2]))
    ms = time_ms(lambda: tsh.wave_shuffle(*args), torch)
    plain_ms = time_ms(lambda: tsh.wave_shuffle_plain(*args), torch)
    # the device time of each of K18's launches (count, scan, scatter,
    # pad); the rest of `ms` is the host's part of the call (the tables'
    # copies, the read of the counts)
    launch_us = _profile_launch_us(torch, lambda: tsh.wave_shuffle(*args),
                                   K18_LAUNCHES)
    return {"workers": w, "producer_rows": _wave_rows(args),
            "device_us_per_launch": launch_us,
            "live_rows": int(sum(gcounts)), "columns": len(template),
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            "bytes": moved}


def measure_k19(torch, tm, args):
    """K19 at the largest merge against its plain version on the same
    CUDA runs (exactly: every column, mask and row_valid), both timed;
    the library figure is one stable torch.sort of the two runs'
    concatenated leading key, the re-sort the merge replaces. The byte
    bound: both runs' row_valid read and the merged row_valid written
    for every slot, the data and mask of each live row read once and
    written once (a dead row's payload is no row)."""
    a, b, keys, desc, nf = args
    got = tm.merge_pair(*args)
    want = tm.merge_pair_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got.row_valid, want.row_valid),
          "K19 merge_pair: row_valid differs")
    live = int(a.row_valid.sum()) + int(b.row_valid.sum())
    moved = 0
    for n in a.names:
        g, w = got.columns[n], want.columns[n]
        check(_same_tensor(torch, g.data, w.data)
              and torch.equal(g.mask, w.mask),
              f"K19 merge_pair: column {n} differs")
        moved += 2 * live * (g.data.element_size() + g.mask.element_size())
    moved += nbytes(got.row_valid, a.row_valid, b.row_valid)
    lead = torch.cat([a.columns[keys[0]].data, b.columns[keys[0]].data])
    ms = time_ms(lambda: tm.merge_pair(*args), torch)
    plain_ms = time_ms(lambda: tm.merge_pair_plain(*args), torch)
    library_ms = time_ms(lambda: torch.sort(lead, stable=True,
                                            descending=bool(desc[0])), torch)
    return {"rows": [a.capacity, b.capacity],
            "live": [int(a.row_valid.sum()), int(b.row_valid.sum())],
            "keys": len(keys), "columns": len(a.names), "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved}


def _profile_launch_us(torch, fn, names, calls=5):
    """Device microseconds per launch of each kernel in `names` over
    `calls` calls of `fn` (None: the profiler saw no such launch). The
    caching allocator's free blocks go back to the card first, and a
    profile that misses a name is taken once more; a miss that stays
    emits the device-side keys the profiler did record."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(2):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [(e.key, getattr(e, "self_device_time_total", 0.0),
                   e.count) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        out = {}
        for k in names:
            # a kernel's key is its demangled signature ("void
            # name<T>(...)" for a template instance)
            hit = [(t, c) for key, t, c in events
                   if re.search(rf"\b{k}\b", key)]
            out[k] = sum(t for t, _ in hit) / sum(c for _, c in hit) \
                if hit else None
        if all(v is not None for v in out.values()):
            return out
    emit({"phase": "profiler_miss", "names": list(names),
          "device_keys": [key[:120] for key, _, _ in events],
          "all_keys": len(prof.key_averages())})
    return out


def measure_k21(torch, df, args):
    """K21 (df_bounds, Triton) at its largest call against its plain
    version (exactly: both bounds); library: torch.aminmax of the live,
    non-NaN keys (selected beforehand). Bound: keys and mask read once."""
    state, data, mask = args
    got = df.bounds_step(state, data, mask)
    want = df.bounds_step_plain(state, data, mask)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        check(_same_tensor(torch, g, w), "K21 df_bounds differs from its "
              f"plain version: {got} vs {want}")
    live = data[mask & ~torch.isnan(data)] if data.is_floating_point() \
        else data[mask]
    moved = nbytes(data, mask)
    return {"rows": data.shape[0], "dtype": str(data.dtype),
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: df.bounds_step(state, data, mask), torch),
            "plain_ms": time_ms(
                lambda: df.bounds_step_plain(state, data, mask), torch),
            "library_ms": time_ms(lambda: torch.aminmax(live), torch),
            "device_us_per_launch": _profile_launch_us(
                torch, lambda: df.bounds_step(state, data, mask),
                ("bounds_partial", "bounds_fold")),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved}


def measure_k22(torch, df, args):
    """K22 (df_distinct_set) at its largest call against its plain
    version: the overflow flag always, the count and every value exactly
    without overflow; library: torch.unique of the live keys (selected
    beforehand). Bound: keys and mask read once."""
    data, mask = args
    gv, gn, go = df.distinct_set(data, mask)
    wv, wn, wo = df.distinct_set_plain(data, mask)
    torch.cuda.synchronize()
    check(bool(go) == bool(wo), "K22 df_distinct_set: overflow differs")
    if not bool(wo):
        check(int(gn) == int(wn) and _same_tensor(torch, gv, wv),
              "K22 df_distinct_set: the set differs from its plain version")
    live = data[mask]
    moved = nbytes(data, mask)
    return {"rows": data.shape[0], "dtype": str(data.dtype),
            "distinct": int(wn), "overflow": bool(wo), "max_abs_err": 0.0,
            "ms": time_ms(lambda: df.distinct_set(data, mask), torch),
            "plain_ms": time_ms(lambda: df.distinct_set_plain(data, mask),
                                torch),
            "library_ms": time_ms(lambda: torch.unique(live), torch),
            "device_us_per_launch": _profile_launch_us(
                torch, lambda: df.distinct_set(data, mask),
                ("df_insert", "df_pack")),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved}


def measure_k23(torch, df, args):
    """K23 (df_apply) at its largest call (one with a set first) against
    its plain version (row_valid exactly); library: torch.isin of the
    keys in the set's values. Bound: keys, mask and row_valid read,
    row_valid written."""
    batch, col, mn, mx, has_set = args[:5]
    rest = args[5:]
    got = df.apply_filter(batch, col, mn, mx, has_set, *rest)
    want = df.apply_filter_plain(batch, col, mn, mx, has_set, *rest)
    torch.cuda.synchronize()
    check(torch.equal(got.row_valid, want.row_valid),
          "K23 df_apply: row_valid differs from its plain version")
    c = batch.columns[col]
    library_ms = None
    if has_set:
        vals = rest[0][:int(rest[1])]
        library_ms = time_ms(lambda: torch.isin(c.data, vals), torch)
    moved = nbytes(c.data, c.mask, batch.row_valid) + batch.capacity
    return {"rows": batch.capacity, "dtype": str(c.data.dtype),
            "with_set": bool(has_set),
            "set_count": int(rest[1]) if has_set else None,
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: df.apply_filter(batch, col, mn, mx,
                                                  has_set, *rest), torch),
            "plain_ms": time_ms(lambda: df.apply_filter_plain(
                batch, col, mn, mx, has_set, *rest), torch),
            "library_ms": library_ms,
            "device_us_per_launch": _profile_launch_us(
                torch, lambda: df.apply_filter(batch, col, mn, mx,
                                               has_set, *rest),
                ("df_apply",)),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved}


#: K20's kernels, in launch order (csrc/exchange_partition.cu)
K20_LAUNCHES = ("partition_count", "partition_scan", "partition_scatter")


def measure_k20(torch, ex, tsh, args):
    """K20 at the largest keyed push against its plain version on the
    same CUDA inputs (exactly: the bounds, row_valid, and every column's
    data and mask over the live prefix), both timed, and the pinned
    read of the live prefix that the push makes next; library: one
    stable torch.sort of the destination vector. Bound: row_valid of
    every slot read and written, the hash of each live row read, the
    data and mask of each live row read and written, the bounds."""
    batch, h, w = args
    from presto_tpu_torch.native.pages import read_to_host
    gb, gbounds = ex.partition_sort(batch, h, w)
    wb, wbounds = ex.partition_sort_plain(batch, h, w)
    torch.cuda.synchronize()
    check(torch.equal(gbounds, wbounds),
          f"K20 exchange_partition: bounds differ: {gbounds} vs {wbounds}")
    live = int(wbounds[-1])
    check(torch.equal(gb.row_valid, wb.row_valid),
          "K20 exchange_partition: row_valid differs")
    for n in batch.names:
        g, x = gb.columns[n], wb.columns[n]
        check(_same_tensor(torch, g.data[:live], x.data[:live])
              and torch.equal(g.mask[:live], x.mask[:live]),
              f"K20 exchange_partition: column {n} differs")
    moved = 2 * batch.capacity + live * h.element_size() \
        + 2 * live * sum(c.data.element_size() + 1
                         for c in batch.columns.values()) + 4 * (w + 1)
    dest = torch.where(batch.row_valid, tsh.partition_dest(h, w),
                       torch.full_like(h, w))
    flat = [t[:live] for n in gb.names for t in gb.columns[n].astuple()]
    reads = []
    for _ in range(ITERS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        read_to_host(flat + [gb.row_valid[:live]])
        reads.append((time.perf_counter() - t) * 1e3)
    return {"rows": batch.capacity, "live_rows": live, "consumers": w,
            "columns": len(batch.names), "max_abs_err": 0.0,
            "ms": time_ms(lambda: ex.partition_sort(batch, h, w), torch),
            "plain_ms": time_ms(lambda: ex.partition_sort_plain(
                batch, h, w), torch),
            "library_ms": time_ms(lambda: torch.sort(dest, stable=True),
                                  torch),
            "device_us_per_launch": _profile_launch_us(
                torch, lambda: ex.partition_sort(batch, h, w),
                K20_LAUNCHES),
            "pinned_read_ms": statistics.median(reads),
            "pinned_read_bytes": nbytes(*flat) + live,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved}


def check_mesh_result(np, torch, label, res, want, collision, order):
    """The query's rows against its oracle; returns the row count."""
    if label == "mesh_order":
        cols = result_columns(torch, np, res)
        for name in ("orderkey", "custkey", "totalprice"):
            d, m = cols[name]
            check(m.all() and len(d) == len(order[name])
                  and np.array_equal(d, order[name]),
                  f"mesh_order: {name} differs from the oracle")
        return len(order["orderkey"])
    rows = res.rows()
    expect = collision if label == "collision" else want[label]
    check(result_matches(label, rows, expect),
          f"mesh {label} differs from the oracle: {rows[:10]} vs "
          f"{expect[:10]}")
    return len(rows)


def run_mesh_phases(torch, np, mods, dev, schema):
    """The distributed path: MESH_QUERIES at `schema` through
    MeshRunner(n_workers=8) on one card, each against its numpy oracle,
    with cold and warm walls, waves, rows and bytes across the
    exchanges, K12 / K18 / K19 launches, the datagen share and the peak
    device memory; one warm execution of Q18 and MESH_ORDER under
    torch.profiler; K18 at the largest wave and K19 at the largest merge
    against their plain versions. Returns ({kernel: measurement},
    {kernel: launches on this path})."""
    tk, tsh, tm = mods["tk"], mods["tsh"], mods["tm"]
    t = time.perf_counter()
    collision, order = mesh_oracle(np, mods["gen"], schema)
    emit({"phase": "mesh_oracle", "seconds": time.perf_counter() - t,
          "mesh_order_rows": len(order["orderkey"])})
    runner = mods["MeshRunner"]("tpch", schema, properties=MESH_PROPS,
                                n_workers=MESH_WORKERS, device=dev)
    check(runner.n_workers == MESH_WORKERS
          and all(d == runner.mesh.device for d in runner.mesh.devices),
          "the mesh's workers are not all on one card")
    counters = list(tk.COUNTERS.values())
    launches = {}
    for label, sql in MESH_QUERIES.items():
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = runner.execute(sql)
        nrows = check_mesh_result(np, torch, label, res, ORACLE_ROWS,
                                  collision, order)
        cold = time.perf_counter() - t
        launches[label] = {c.name: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated()
        ex = list(runner.last_exchanges.values())
        waves = sum(x.wave_count for x in ex)
        for k in MESH_MUST[label]:
            check(launches[label][k] > 0, f"{k} was not launched in mesh "
                  f"{label}")
        check(launches[label]["exchange_shuffle"] == waves,
              f"mesh {label}: {waves} waves but "
              f"{launches[label]['exchange_shuffle']} K18 launches")
        with DatagenTimer(mods["gen"].TpchGenerator) as dg:
            t = time.perf_counter()
            r = runner.execute(sql)
            if label == "mesh_order":
                result_columns(torch, np, r)
            else:
                r.rows()
            warm = time.perf_counter() - t
        emit({"phase": "mesh", "query": label, "schema": schema,
              "workers": MESH_WORKERS, "batch_rows": PROPS["batch_rows"],
              "rows": nrows, "matches_oracle": True, "cold_s": cold,
              "warm_s": warm, "warm_datagen_share": dg.seconds / warm,
              "waves": waves,
              "exchange_rows": sum(x.wave_rows for x in ex),
              "exchange_bytes": sum(x.wave_bytes for x in ex),
              "exchanges": {x.exchange_id: x.scheme for x in ex},
              "k12_launches": launches[label]["fragment"],
              "k18_launches": launches[label]["exchange_shuffle"],
              "k19_launches": launches[label]["merge_pair"],
              "peak_device_bytes": peak, "launches": launches[label]})
    for label in ("q18", "mesh_order"):
        emit({"phase": "profile", "path": "mesh", "query": label,
              **profile_query(torch, mods["gen"], runner,
                              MESH_QUERIES[label],
                              read=(lambda r: result_columns(torch, np, r))
                              if label == "mesh_order" else None)})
    # K18 at the largest wave, K19 at the largest merge
    with ArgCapture(tsh, "wave_shuffle", _wave_rows) as waves_cap, \
            ArgCapture(tm, "merge_pair",
                       lambda a: a[0].capacity + a[1].capacity) as merges:
        for label in ("q18", "q3", "q1", "mesh_order"):
            waves_cap.query = merges.query = label
            runner.execute(MESH_QUERIES[label])
    check(waves_cap.big is not None and merges.big is not None,
          "the largest wave or merge was not captured")
    k18 = measure_k18(torch, tsh, waves_cap.big[2])
    emit({"phase": "kernels", "kernel": "exchange_shuffle",
          "family": "spmd_shuffle", "shape_from": waves_cap.big[1], **k18,
          "launches": {q: launches[q]["exchange_shuffle"]
                       for q in MESH_QUERIES}})
    k19 = measure_k19(torch, tm, merges.big[2])
    emit({"phase": "kernels", "kernel": "merge_pair", "family": "merge",
          "shape_from": merges.big[1], **k19,
          "launches": {q: launches[q]["merge_pair"] for q in MESH_QUERIES}})
    totals = {name: sum(launches[q][name] for q in MESH_QUERIES)
              for name in tk.COUNTERS}
    return {"exchange_shuffle": k18, "merge_pair": k19}, totals


# -- the control plane (A13): a coordinator and worker processes ----------

#: a join whose build side (nation) is broadcast into the fragment that
#: scans its probe side (customer): the worker plans a dynamic filter
#: there (K21 at the build, K22 at its finish, K23 on every customer
#: batch). The plans of Q1-Q18 repartition every probe side, so a
#: co-fragment filter, the only kind the HTTP path plans (as in the
#: reference), has no scan to prune in them.
DF_JOIN = """select c.nationkey, count(*) c from customer c
join nation n on c.nationkey = n.nationkey where n.regionkey = 1
group by c.nationkey order by c.nationkey"""
SERVER_QUERIES = {"q1": Q1, "q3": Q3, "q5": Q5, "q6": Q6, "q18": Q18,
                  "df_join": DF_JOIN}
SERVER_WORKERS = 2
#: the second round: each worker runs its fragments as 4 logical devices
#: of the card (8 global consumer tasks)
SERVER_DEVICES = 4
SERVER_MESH_QUERIES = ("q18", "q3")
#: seconds a worker may take to start (imports, CUDA context)
WORKER_START_S = 240
#: where the workers' stderr goes (worker-<i>.log): the package's build
#: directory, which git ignores
WORKER_LOGS = __import__("pathlib").Path(__file__).resolve().parent \
    / "presto_tpu_torch" / "_build" / "worker-logs"
#: the queries whose fragments repartition on keys over HTTP (K20);
#: Q6's single aggregate only gathers
SERVER_KEYED = ("q1", "q3", "q5", "q18")
DF_KERNELS = ("df_bounds", "df_distinct_set", "df_apply")


def df_join_oracle(np, gen_module, schema):
    """DF_JOIN in numpy: customers per nation of region 1."""
    gen = gen_module.TpchGenerator(gen_module.TpchConnector.SCHEMAS[schema])
    cust = table(np, gen, "customer", ("nationkey",))
    nation = table(np, gen, "nation", ("nationkey", "regionkey"))
    keep = nation["nationkey"][nation["regionkey"] == 1]
    counts = np.bincount(cust["nationkey"][np.isin(cust["nationkey"],
                                                   keep)])
    return [(int(k), int(c)) for k, c in enumerate(counts) if c]


def _worker_infos(urls):
    from presto_tpu_torch.server.node import http_get
    return [json.loads(http_get(f"{u}/v1/info", timeout=60)) for u in urls]


def _delta(after, before, key):
    return {k: v - before[key].get(k, 0) for k, v in after[key].items()
            if v - before[key].get(k, 0)}


def run_server_queries(torch, np, tk, coord, urls, labels, devices):
    """Each query of `labels` cold (launch and traffic deltas read from
    every worker's /v1/info around it; the coordinator's own counters
    set to 0 before it), then warm; rows against the TPC-H path's
    oracle. Returns {label: summed launches over every process}."""
    from presto_tpu_torch.server import node as tnode
    counters = list(tk.COUNTERS.values())
    launches = {}
    for label in labels:
        sql = SERVER_QUERIES[label]
        before = _worker_infos(urls)
        for c in counters:
            c.launches = 0
        calls0 = dict(tk.CALLS)
        traffic0 = dict(tnode.TRAFFIC)
        t = time.perf_counter()
        rows = coord.execute(sql).rows()
        cold = time.perf_counter() - t
        mine = {c.name: c.launches for c in counters}
        after = _worker_infos(urls)
        check(result_matches(label, rows, ORACLE_ROWS[label]),
              f"server {label} differs from the oracle: {rows[:10]} vs "
              f"{ORACLE_ROWS[label][:10]}")
        per_worker = [_delta(a, b, "kernels") for a, b in zip(after, before)]
        traffic = [_delta(a, b, "traffic") for a, b in zip(after, before)]
        calls = collections.Counter({f: n - calls0.get(f, 0)
                                     for f, n in tk.CALLS.items()})
        for a, b in zip(after, before):
            calls.update(_delta(a, b, "calls"))
        total = collections.Counter(mine)
        for w in per_worker:
            total.update(w)
        launches[label] = dict(total)
        for i, (k, tr) in enumerate(zip(per_worker, traffic)):
            check(k.get("exchange_partition", 0) == tr.get("keyed", 0),
                  f"server {label}: worker {i} made {tr.get('keyed', 0)} "
                  f"keyed pushes but {k.get('exchange_partition', 0)} K20 "
                  "launches")
        if label in SERVER_KEYED:
            check(total["exchange_partition"] > 0,
                  f"server {label}: no keyed push launched K20")
        if label == "df_join":
            check(calls["dynamic_filter"] > 0,
                  "server df_join planned no dynamic filter")
        if calls["dynamic_filter"]:
            for k in DF_KERNELS:
                check(total[k] > 0, f"server {label} has a dynamic filter "
                      f"but launched no {k}")
        t = time.perf_counter()
        coord.execute(sql).rows()
        warm = time.perf_counter() - t
        coord_traffic = {k: v - traffic0.get(k, 0)
                         for k, v in tnode.TRAFFIC.items()}
        emit({"phase": "server", "query": label, "workers": len(urls),
              "devices_per_worker": devices, "rows": len(rows),
              "matches_oracle": True, "cold_s": cold, "warm_s": warm,
              "single_device_warm_s": SINGLE_WARM.get(label),
              "http_pages": sum(t.get("pages", 0) for t in traffic)
              + coord_traffic.get("pages", 0),
              "http_bytes": sum(t.get("bytes", 0) for t in traffic)
              + coord_traffic.get("bytes", 0),
              "local_deliveries": sum(t.get("local", 0) for t in traffic)
              + coord_traffic.get("local", 0),
              "keyed_pushes": [t.get("keyed", 0) for t in traffic],
              "dynamic_filter_calls": calls["dynamic_filter"],
              "k20_k23_per_worker": [
                  {k: w.get(k, 0) for k in ("exchange_partition",)
                   + DF_KERNELS} for w in per_worker],
              "k20_k23_coordinator": {k: mine.get(k, 0) for k in
                                      ("exchange_partition",) + DF_KERNELS},
              "launches": launches[label]})
    return launches


def run_server_phases(torch, np, mods, dev, schema):
    """The control plane: SERVER_WORKERS worker processes on the card and
    a Coordinator in this process; SERVER_QUERIES (bench.py's five and
    DF_JOIN) at `schema` cold and
    warm through the coordinator, one query through StatementClient and
    one through the CLI; then the workers again with SERVER_DEVICES
    logical devices each for SERVER_MESH_QUERIES; K20 held against its
    plain version at the largest keyed push of Q18 (captured in an
    in-process cluster before the workers start). Returns ({kernel:
    measurement}, {kernel: launches on this path})."""
    tk = mods["tk"]
    from presto_tpu_torch.native import codec
    from presto_tpu_torch.operators import exchange_ops as tex
    from presto_tpu_torch.server.coordinator import (
        Coordinator, StatementClient,
    )
    from presto_tpu_torch.server.node import (
        Node, spawn_workers, stop_workers,
    )
    check(codec.native_available(), "the native page codec did not load")
    ORACLE_ROWS["df_join"] = df_join_oracle(np, mods["gen"], schema)
    # K20 at the largest keyed push of Q18, captured in an in-process
    # cluster (the pushes of the worker processes are out of reach), and
    # measured first: after the worker processes' phases below this
    # process's profiler recorded no device activity at all
    nodes = [Node(device=dev) for _ in range(SERVER_WORKERS)]
    for n in nodes:
        n.start()
    coord = Coordinator([n.url for n in nodes], "tpch", schema, PROPS,
                        device=dev)
    coord.start()
    try:
        with ArgCapture(tex, "partition_sort",
                        lambda a: a[0].capacity) as pushes:
            pushes.query = "q18"
            coord.execute(Q18).rows()
    finally:
        coord.stop()
        for n in nodes:
            n.stop()
    check(pushes.big is not None, "no keyed push was captured from Q18")
    k20 = measure_k20(torch, tex, mods["tsh"], pushes.big[2])
    totals = collections.Counter()
    for devices, labels in ((1, tuple(SERVER_QUERIES)),
                            (SERVER_DEVICES, SERVER_MESH_QUERIES)):
        t = time.perf_counter()
        procs, urls = spawn_workers(
            SERVER_WORKERS, ["--devices", str(devices)]
            + (["--device", "cpu"] if dev.type == "cpu" else []),
            timeout_s=WORKER_START_S, log_dir=WORKER_LOGS)
        coord = None
        try:
            coord = Coordinator(urls, "tpch", schema, PROPS, device=dev)
            coord.start()
            report = coord.check_workers(require_all=True)
            check(coord._worker_devices(urls) == [devices] * len(urls),
                  "the workers do not announce their devices")
            emit({"phase": "server_start", "workers": report,
                  "devices_per_worker": devices,
                  "seconds": time.perf_counter() - t})
            for label, n in run_server_queries(
                    torch, np, tk, coord, urls, labels, devices).items():
                totals.update(n)
            if devices == 1:
                cols, data = StatementClient(coord.url).execute(Q6)
                check(result_matches("q6", [tuple(r) for r in data],
                                     ORACLE_ROWS["q6"]),
                      "q6 through StatementClient differs from the oracle")
                sql = "select count(*) from orders"
                want = coord.execute(sql).rows()[0][0]
                out = subprocess.run(
                    [sys.executable, "-m", "presto_tpu_torch.cli",
                     "--server", coord.url, "-e", sql],
                    capture_output=True, text=True, timeout=300)
                check(out.returncode == 0 and str(want) in out.stdout,
                      f"the CLI against the coordinator: {out.stderr}")
                emit({"phase": "server_clients", "statement_client": "q6",
                      "columns": [c["name"] for c in cols],
                      "cli": out.stdout.strip().splitlines()[-1]})
        finally:
            if coord is not None:
                coord.stop()
            stop_workers(procs)
    emit({"phase": "kernels", "kernel": "exchange_partition",
          "family": "exchange_partition", "shape_from": "q18", **k20,
          "launches": totals["exchange_partition"]})
    return {"exchange_partition": k20}, \
        {name: totals[name] for name in tk.COUNTERS}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    try:
        import numpy as np
        from presto_tpu_torch import batch as tb
        from presto_tpu_torch import types as tt
        from presto_tpu_torch.connectors import tpcds as ds_module
        from presto_tpu_torch.connectors import tpch as gen_module
        from presto_tpu_torch.execution import dynamic_filters as tdf
        from presto_tpu_torch.expr import codegen
        from presto_tpu_torch.native import cuda
        from presto_tpu_torch.native import pages as tpages
        from presto_tpu_torch.operators import fused_fragment as tff
        from presto_tpu_torch.operators import aggregation as tagg
        from presto_tpu_torch.operators import array_agg as taa
        from presto_tpu_torch.operators import core as tcore
        from presto_tpu_torch.operators import misc_ops as tmisc
        from presto_tpu_torch.ops import agg_kernels as tak
        from presto_tpu_torch.ops import common as tc
        from presto_tpu_torch.ops import hashagg as th
        from presto_tpu_torch.ops import join as tj
        from presto_tpu_torch.ops import sort as tsort
        from presto_tpu_torch.ops import merge as tm
        from presto_tpu_torch.ops import window as tw
        from presto_tpu_torch.parallel import shuffle as tsh
        from presto_tpu_torch.runner import LocalRunner, MeshRunner
        from presto_tpu_torch.telemetry import kernels as tk
    except ImportError as e:
        print(f"chip_smoke: the presto_tpu_torch package is not beside "
              f"this script: {e}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    mods = {"tb": tb, "tt": tt, "gen": gen_module, "th": th, "tc": tc,
            "tj": tj, "df": tdf, "agg": tagg, "core": tcore, "sort": tsort,
            "misc": tmisc, "codegen": codegen, "ff": tff,
            "tk": tk, "tw": tw, "ds": ds_module, "taa": taa,
            "tsh": tsh, "tm": tm, "ak": tak, "pages": tpages,
            "LocalRunner": LocalRunner, "MeshRunner": MeshRunner}
    check(set(KERNELS) == set(tk.COUNTERS)
          and {src for route, src, _ in KERNELS.values()
               if route == "cuda"}
          == {"presto_tpu_torch/csrc/" + s for s in cuda.SOURCES.values()},
          "KERNELS, the launch counters and native/cuda.py SOURCES "
          "disagree")

    # 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    secs = cuda.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_seconds": secs,
          "flags": " ".join(cuda.NVCC_FLAGS)})

    # 2. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    device_name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": device_name,
          "capability": list(torch.cuda.get_device_capability(0)),
          "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    check(torch.cuda.get_device_capability(0) >= (9, 0),
          "the kernels are built for sm_90a")

    kernels, tpch_launches, build_sort = run_phases(torch, np, mods, dev,
                                                    SCHEMA)
    sort, sort_launches = run_sort_phases(torch, np, mods, dev, SCHEMA)
    agg, agg_launches = run_agg_phases(torch, np, mods, dev, SCHEMA)
    window, window_launches = run_window_phases(torch, np, mods, dev,
                                                SCHEMA)
    k17, array_launches = run_array_phases(torch, np, mods, dev, SCHEMA)
    mesh, mesh_launches = run_mesh_phases(torch, np, mods, dev, SCHEMA)
    server, server_launches = run_server_phases(torch, np, mods, dev,
                                                SCHEMA)
    # K25's figures are those of its largest call: Q21's lineitem build
    sort["radix_sort"] = build_sort
    for k in kernels:
        k["launches"] += window_launches[k["name"]] \
            + array_launches[k["name"]] + mesh_launches[k["name"]] \
            + server_launches[k["name"]] + sort_launches[k["name"]] \
            + agg_launches[k["name"]]
    for kname, m in [(n, window[n]) for n in WINDOW_KERNELS] \
            + [(n, k17) for n in ARRAY_KERNELS] \
            + [(n, mesh[n]) for n in MESH_KERNELS] \
            + [(n, server[n]) for n in SERVER_KERNELS] \
            + [(n, sort[n]) for n in SORT_KERNELS] \
            + [(n, agg[n]) for n in AGG_KERNELS]:
        route, src, replaces = KERNELS[kname]
        kernels.append({
            "name": kname, "route": route, "source": src,
            "replaces": replaces, "family": tk.COUNTERS[kname].family,
            "launches": window_launches[kname] + array_launches[kname]
            + mesh_launches[kname] + server_launches[kname]
            + sort_launches[kname] + agg_launches[kname]
            + (tpch_launches[kname] if kname in SORT_KERNELS else 0),
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": "bytes", "library_ms": m["library_ms"]})
    check(all(k["launches"] > 0 for k in kernels),
          "kernels the paths never launched: "
          f"{[k['name'] for k in kernels if not k['launches']]}")
    print(smi_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
