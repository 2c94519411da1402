#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (presto_tpu_torch) on one NVIDIA
GPU: build its hand-written kernels, hold each against its plain PyTorch
version at the shapes the main path gives it, run TPC-H Q1 and Q6 at
SF1 through LocalRunner, and check the rows against a numpy oracle.

    python3 chip_smoke.py

Each phase prints one JSON line. The line before the last is the
per-kernel summary ({"kernels": [...]}), the line before that the
card's name and power limit from nvidia-smi, and the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before that
last line. The script needs a CUDA device, nvcc (CUDA_HOME,
/usr/local/cuda or PATH) and the repository beside it; it imports
nothing of JAX.

Main path: LocalRunner("tpch", "sf1", properties={"batch_rows": 1<<20})
executes Q1 and Q6 once each with every kernel's launch counter set to
0 just before the query and read just after. Those counts are the
"launches" of the summary line. The kernel measurements run on inputs
captured from a separate run of the same queries (the largest call of
each kernel), so their shapes are the main path's; compact is also
measured on a 1M-row lineitem batch at ~2% and ~98% live. Launches
made while comparing or timing are not counted.

Tolerances: K2 (compact) must match its plain version exactly (the row
order is the result). K1 (direct_slot_reduce) integers must match
exactly; float64 components to a relative 1e-9, because atomics add in
a run-dependent order. Query results: DOUBLE columns to a relative
1e-6 (the repository's TPC-H comparison rule), everything else exact,
Q1 in order.
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
            "linestatus", "shipdate")
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
    a copy of the inputs of each kernel's largest call."""

    def __init__(self, tb, th):
        self.tb, self.th = tb, th
        self.k1 = {}   # query -> (rows, args)
        self.k2 = {}   # query -> (rows, batch, out_cap)
        self.query = None

    def __enter__(self):
        tb, th = self.tb, self.th
        self._orig = (th.direct_slot_reduce, tb.compact_shrink)
        slot_reduce, shrink = self._orig

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
        th.direct_slot_reduce = rec_slot_reduce
        tb.compact_shrink = rec_shrink
        return self

    def __exit__(self, *exc):
        self.th.direct_slot_reduce, self.tb.compact_shrink = self._orig
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
        from presto_tpu_torch.ops import hashagg as th
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
    n_lineitem = len(lineitem["quantity"])
    runner = LocalRunner("tpch", SCHEMA, properties=PROPS, device=dev)
    counters = (th.SLOT_REDUCE_KERNEL, tb.COMPACT_KERNEL)
    launches, walls, results = {}, {}, {}
    for label, sql in (("q1", Q1), ("q6", Q6)):
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
    check(rows_match(results["q1"], want_q1),
          f"Q1 differs from the oracle: {results['q1']} vs {want_q1}")
    check(rows_match(results["q6"], want_q6),
          f"Q6 differs from the oracle: {results['q6']} vs {want_q6}")
    for label in ("q1", "q6"):
        check(launches[label]["direct_slot_reduce"] > 0,
              f"K1 was not launched in {label}")
    check(launches["q6"]["compact"] > 0, "K2 was not launched in Q6")
    for label in ("q1", "q6"):
        cold, warm = walls[label]
        emit({"phase": "tpch", "query": label, "schema": SCHEMA,
              "batch_rows": PROPS["batch_rows"], "rows": results[label],
              "matches_oracle": True, "launches": launches[label],
              "cold_s": cold, "warm_s": warm,
              "lineitem_rows": n_lineitem,
              "warm_rows_per_s": n_lineitem / warm})

    # 4. where a warm query's time goes --------------------------------
    for label, sql in (("q1", Q1), ("q6", Q6)):
        emit({"phase": "profile", "query": label,
              **profile_query(torch, gen_module, runner, sql)})

    # 5. kernels at the main path's shapes ----------------------------
    with Capture(tb, th) as cap:
        for label, sql in (("q1", Q1), ("q6", Q6)):
            cap.query = label
            runner.execute(sql).rows()
    check(set(cap.k1) == {"q1", "q6"} and "q6" in cap.k2,
          "kernel inputs were not captured from the main path")
    k1 = {q: measure_k1(torch, th, cap.k1[q][1], q) for q in ("q1", "q6")}
    _, q6_batch, q6_cap = cap.k2["q6"]
    k2 = {"q6_shrink": measure_k2(torch, tb, q6_batch, q6_cap,
                                  "q6 shrink")}
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

    def summary(name, source, replaces, m, total):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": total,
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": "bytes", "library_ms": m["library_ms"]}
    kernels = [
        summary("direct_slot_reduce", "presto_tpu_torch/csrc/slot_reduce.cu",
                "presto_tpu/ops/hashagg.py:884", k1["q1"],
                sum(v["direct_slot_reduce"] for v in launches.values())),
        summary("compact", "presto_tpu_torch/csrc/compact.cu",
                "presto_tpu/batch.py:450", k2["q6_shrink"],
                sum(v["compact"] for v in launches.values())),
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
