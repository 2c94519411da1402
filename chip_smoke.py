#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (presto_tpu_torch) on one NVIDIA
GPU: build its hand-written kernels, hold each against its plain PyTorch
version at the shapes the main path gives it, run TPC-H Q1, Q3, Q5, Q6
and Q13 at SF1 through LocalRunner, and check the rows against a numpy
oracle.

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
"launches" of the summary line), then three times warm. The kernels:
K1 direct_slot_reduce, K2 compact, K3 row_hash, K4 join_build, K5
join_probe, K6 segment_reduce. The kernel measurements run on inputs
captured from a separate run of the same queries (the largest call of
each kernel), so their shapes are the main path's; compact is also
measured on a 1M-row lineitem batch at ~2% and ~98% live. Launches
made while comparing or timing are not counted. K4 and K6 also report
the time of the `torch.sort` that precedes them on the main path.

Tolerances: K2 (compact), K3, K4 and K5 must match their plain versions
exactly (row order, hashes, offsets and slots are the result). K1
(direct_slot_reduce) integers must match exactly; float64 components
to a relative 1e-9, because atomics add in a run-dependent order. K6
(segment_reduce) first rows, group counts, the overflow flag and
integer components exactly, float64 components to a relative 1e-9 (a
lane-strided tree order against the plain version's row order). Query
results: DOUBLE columns to a relative 1e-6 (the repository's TPC-H
comparison rule), everything else exact, in the query's order.
"""

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

QUERIES = {"q1": Q1, "q3": Q3, "q5": Q5, "q6": Q6, "q13": Q13}


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


def oracle(np, gen_module):
    """Q1 and Q6 in numpy over the same generated lineitem (the
    connector's generator, chunk by chunk). Returns (Q1 rows, Q6 rows,
    the lineitem columns Q1 reads)."""
    gen = gen_module.TpchGenerator(gen_module.TpchConnector.SCHEMAS[SCHEMA])
    norders = gen.rows("orders")
    cols = ("quantity", "extendedprice", "discount", "tax", "returnflag",
            "linestatus", "shipdate", "orderkey", "suppkey")
    parts = {c: [] for c in cols}
    step = 1 << 18
    for lo in range(0, norders, step):
        d = gen.generate("lineitem", lo, min(lo + step, norders))
        for c in cols:
            parts[c].append(d[c])
    li = {c: np.concatenate(v) for c, v in parts.items()}
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


def join_oracle(np, gen_module, li):
    """Q3, Q5 and Q13 in numpy over the same generated tables: joins by
    searchsorted on sorted keys, grouping by np.unique / np.bincount."""
    import re
    gen = gen_module.TpchGenerator(gen_module.TpchConnector.SCHEMAS[SCHEMA])
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


def rows_match(got, want) -> bool:
    """The repository's TPC-H rule: floats to rel 1e-6, the rest
    exactly, in order."""
    import math
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

class Capture:
    """Wraps the kernel wrappers during one run of the queries and keeps
    the inputs of each kernel's largest call: a copy for K1 and K2
    (K1 updates its state in place), references for K3-K6 (their
    inputs are not written after the call)."""

    def __init__(self, tb, th, tc, tj):
        self.tb, self.th, self.tc, self.tj = tb, th, tc, tj
        self.k1 = {}   # query -> (rows, args)
        self.k2 = {}   # query -> (rows, batch, out_cap)
        self.big = {}  # kernel -> (rows, query, args)
        #: the composed probe expand: layout -> (output slots, query,
        #: args) of its largest call, and calls per (query, layout)
        self.expand = {}
        self.expand_calls = {}
        self.query = None

    def _keep(self, kernel, rows, args):
        if rows > self.big.get(kernel, (0,))[0]:
            self.big[kernel] = (rows, self.query, args)

    def __enter__(self):
        tb, th, tc, tj = self.tb, self.th, self.tc, self.tj
        self._orig = (th.direct_slot_reduce, tb.compact_shrink,
                      tc.row_hash_pair, tj.build_meta, tj.probe_search,
                      th.segment_reduce, tj._expand_from_enc)
        (slot_reduce, shrink, row_hash, build_meta, probe, seg,
         expand) = self._orig

        def rec_slot_reduce(row_valid, keys, domains, comps, present):
            n = row_valid.shape[0]
            if n > self.k1.get(self.query, (0,))[0]:
                self.k1[self.query] = (n, (
                    row_valid.clone(),
                    [(c.clone(), m.clone()) for c, m in keys], domains,
                    [(c.clone(), s.clone(), r) for c, s, r in comps],
                    present.clone()))
            return slot_reduce(row_valid, keys, domains, comps, present)

        def rec_shrink(batch, capacity):
            if batch.capacity > self.k2.get(self.query, (0,))[0]:
                copy = tb.Batch({n: tb.Column(c.data.clone(),
                                              c.mask.clone(), c.type,
                                              c.dictionary)
                                 for n, c in batch.columns.items()},
                                batch.row_valid.clone())
                self.k2[self.query] = (batch.capacity, copy, capacity)
            return shrink(batch, capacity)

        def rec_row_hash(keys, row_valid, nulls_invalid):
            self._keep("row_hash", row_valid.shape[0],
                       (keys, row_valid, nulls_invalid))
            return row_hash(keys, row_valid, nulls_invalid)

        def rec_build_meta(sh, k):
            self._keep("join_build", sh.shape[0], (sh, k))
            return build_meta(sh, k)

        def rec_probe(table, batch, key_names, verify="hash"):
            self._keep("join_probe", batch.capacity,
                       (table, batch, key_names, verify))
            return probe(table, batch, key_names, verify)

        def rec_seg(h1, h2, keys, valid, comps, out_cap):
            self._keep("segment_reduce", valid.shape[0],
                       (h1, h2, keys, valid, comps, out_cap))
            return seg(h1, h2, keys, valid, comps, out_cap)

        def rec_expand(table, probe, *args):
            out_capacity = args[2]
            layout = "aligned" if table.unique_runs \
                and out_capacity == probe.capacity else "general"
            key = (self.query, layout)
            self.expand_calls[key] = self.expand_calls.get(key, 0) + 1
            if out_capacity > self.expand.get(layout, (0,))[0]:
                self.expand[layout] = (out_capacity, self.query,
                                       (table, probe, *args))
            return expand(table, probe, *args)
        th.direct_slot_reduce = rec_slot_reduce
        tb.compact_shrink = rec_shrink
        tc.row_hash_pair = rec_row_hash
        tj.build_meta = rec_build_meta
        tj.probe_search = rec_probe
        th.segment_reduce = rec_seg
        tj._expand_from_enc = rec_expand
        return self

    def __exit__(self, *exc):
        (self.th.direct_slot_reduce, self.tb.compact_shrink,
         self.tc.row_hash_pair, self.tj.build_meta, self.tj.probe_search,
         self.th.segment_reduce, self.tj._expand_from_enc) = self._orig
        return False


# -- phases ------------------------------------------------------------------

def profile_query(torch, gen_module, runner, sql):
    """One warm execution under torch.profiler: wall time, the host
    seconds spent generating tpch data, device busy time (the sum of
    the kernels' self device time) and the kernels that took most of
    it. `device_busy_ms` is None when the profiler recorded no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    gen_cls = gen_module.TpchGenerator
    orig = gen_cls.generate
    datagen = [0.0]

    def timed_generate(self, *args, **kwargs):
        t = time.perf_counter()
        try:
            return orig(self, *args, **kwargs)
        finally:
            datagen[0] += time.perf_counter() - t
    gen_cls.generate = timed_generate
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            runner.execute(sql).rows()
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
    return {"wall_s": wall, "datagen_s": datagen[0],
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
    sort_ms = time_ms(lambda: tc.lex_perm([s1, s2]), torch)
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
            "torch_sort_ms": sort_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def measure_expand(torch, tj, args, calls):
    """The composed torch expand after K5 (ROADMAP B7 queues its hand
    kernel): time of its largest call in one layout, and its calls per
    query in the capture run."""
    table, probe = args[0], args[1]
    out_capacity = args[4]
    fn = lambda: tj._expand_from_enc(*args)  # noqa: E731
    return {"probe_rows": probe.capacity, "out_capacity": out_capacity,
            "build_rows": int(table.sorted_hash.shape[0]),
            "ms": time_ms(fn, torch), "calls": calls}


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
        from presto_tpu_torch.connectors import tpch as gen_module
        from presto_tpu_torch.native import cuda
        from presto_tpu_torch.ops import common as tc
        from presto_tpu_torch.ops import hashagg as th
        from presto_tpu_torch.ops import join as tj
        from presto_tpu_torch.runner import LocalRunner
    except ImportError as e:
        print(f"chip_smoke: the presto_tpu_torch package is not beside "
              f"this script: {e}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")

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
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name,
          "capability": list(torch.cuda.get_device_capability(0)),
          "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    check(torch.cuda.get_device_capability(0) >= (9, 0),
          "the kernels are built for sm_90a")

    # 3. tpch: the main path ------------------------------------------
    want_q1, want_q6, lineitem = oracle(np, gen_module)
    want = {"q1": want_q1, "q6": want_q6,
            **join_oracle(np, gen_module, lineitem)}
    n_lineitem = len(lineitem["quantity"])
    runner = LocalRunner("tpch", SCHEMA, properties=PROPS, device=dev)
    counters = (th.SLOT_REDUCE_KERNEL, tb.COMPACT_KERNEL,
                tc.ROW_HASH_KERNEL, tj.JOIN_BUILD_KERNEL,
                tj.JOIN_PROBE_KERNEL, th.SEGMENT_REDUCE_KERNEL)
    launches, walls, results = {}, {}, {}
    for label, sql in QUERIES.items():
        for c in counters:
            c.launches = 0
        t = time.perf_counter()
        results[label] = runner.execute(sql).rows()
        cold = time.perf_counter() - t
        launches[label] = {c.name: c.launches for c in counters}
        warm = []
        for _ in range(3):
            t = time.perf_counter()
            runner.execute(sql).rows()
            warm.append(time.perf_counter() - t)
        walls[label] = (cold, statistics.median(warm))
    for label in QUERIES:
        check(rows_match(results[label], want[label]),
              f"{label} differs from the oracle: {results[label]} vs "
              f"{want[label]}")
    #: the kernels each query's plan must launch
    must = {"q1": ("direct_slot_reduce",),
            "q6": ("direct_slot_reduce", "compact"),
            "q3": ("row_hash", "join_build", "join_probe",
                   "segment_reduce"),
            "q5": ("row_hash", "join_build", "join_probe",
                   "direct_slot_reduce"),
            "q13": ("row_hash", "join_build", "join_probe",
                    "segment_reduce")}
    for label, names in must.items():
        for k in names:
            check(launches[label][k] > 0,
                  f"{k} was not launched in {label}")
    for label in QUERIES:
        cold, warm = walls[label]
        emit({"phase": "tpch", "query": label, "schema": SCHEMA,
              "batch_rows": PROPS["batch_rows"], "rows": results[label],
              "matches_oracle": True, "launches": launches[label],
              "cold_s": cold, "warm_s": warm,
              "lineitem_rows": n_lineitem,
              "warm_lineitem_rows_per_s": n_lineitem / warm})

    # 4. where a warm query's time goes --------------------------------
    for label, sql in QUERIES.items():
        emit({"phase": "profile", "query": label,
              **profile_query(torch, gen_module, runner, sql)})

    # 5. kernels at the main path's shapes ----------------------------
    with Capture(tb, th, tc, tj) as cap:
        for label, sql in QUERIES.items():
            cap.query = label
            runner.execute(sql).rows()
    check({"q1", "q6"} <= set(cap.k1) and "q6" in cap.k2
          and set(cap.big) == {"row_hash", "join_build", "join_probe",
                               "segment_reduce"},
          "kernel inputs were not captured from the main path")
    k1 = {q: measure_k1(torch, th, cap.k1[q][1], q) for q in ("q1", "q6")}
    _, q6_batch, q6_cap = cap.k2["q6"]
    k2 = {"q6_shrink": measure_k2(torch, tb, q6_batch, q6_cap,
                                  "q6 shrink")}
    big = {k: v[2] for k, v in cap.big.items()}
    shape_from = {k: v[1] for k, v in cap.big.items()}
    k36 = {"row_hash": measure_k3(torch, tc, big["row_hash"]),
           "join_build": measure_k4(torch, tj, big["join_build"]),
           "join_probe": measure_k5(torch, tc, tj, big["join_probe"]),
           "segment_reduce": measure_k6(torch, tc, th,
                                        big["segment_reduce"])}
    expand = {layout: (q, measure_expand(
        torch, tj, args, {qq: n for (qq, lay), n in cap.expand_calls.items()
                          if lay == layout}))
        for layout, (_, q, args) in cap.expand.items()}
    del big, cap
    # a 1M-row lineitem-shaped batch (the seven columns Q1 reads) with
    # Q6's predicate as row_valid (~2% live, shrunk) and its complement
    # (~98% live, the full variant; Q1's own predicate keeps every row
    # of this generator)
    n = 1 << 20
    types = {"quantity": tt.DOUBLE, "extendedprice": tt.DOUBLE,
             "discount": tt.DOUBLE, "tax": tt.DOUBLE,
             "returnflag": tt.VARCHAR, "linestatus": tt.VARCHAR,
             "shipdate": tt.DATE}
    wide = tb.Batch.from_numpy({c: lineitem[c][:n] for c in types},
                               types, device=dev)
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
    for k, m in k36.items():
        emit({"phase": "kernels", "kernel": k, "shape_from": shape_from[k],
              **m})
    for layout, (q, m) in expand.items():
        emit({"phase": "kernels", "kernel": "join_probe expand (torch)",
              "layout": layout, "shape_from": q, **m})

    def summary(name, source, replaces, m):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(v[name] for v in launches.values()),
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": "bytes", "library_ms": m["library_ms"]}
    src = "presto_tpu_torch/csrc/"
    kernels = [
        summary("direct_slot_reduce", src + "slot_reduce.cu",
                "presto_tpu/ops/hashagg.py:884", k1["q1"]),
        summary("compact", src + "compact.cu", "presto_tpu/batch.py:450",
                k2["q6_shrink"]),
        summary("row_hash", src + "row_hash.cu",
                "presto_tpu/ops/common.py:167", k36["row_hash"]),
        summary("join_build", src + "join_build.cu",
                "presto_tpu/ops/join.py:248", k36["join_build"]),
        summary("join_probe", src + "join_probe.cu",
                "presto_tpu/ops/join.py:353", k36["join_probe"]),
        summary("segment_reduce", src + "segment_reduce.cu",
                "presto_tpu/ops/hashagg.py:569", k36["segment_reduce"]),
    ]
    print(smi_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
