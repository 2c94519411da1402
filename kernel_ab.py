#!/usr/bin/env python3
"""Time DISTINCT's fold (`distinct_step`) and the join's expansion
(`_expand_from_enc`, K9) in this checkout beside another checkout of
the repository (its parent commit, say) on one NVIDIA GPU, on the same
captured calls:

    python3 kernel_ab.py --other DIR [--work DIR] [--out FILE]

1. Capture (one process, this checkout): the queries that chip_smoke.py's
   MUST table says launch `join_expand` or `distinct_set` go through
   LocalRunner at chip_smoke's schemas and properties with
   `distinct_step` and `_expand_from_enc` wrapped, and these calls are
   saved with torch.save: the largest fold, K9's largest general call,
   and K9's largest call at each of chip_smoke's EXPAND_AT (query,
   layout) pairs within its slot limit.
2. Measure, one process per checkout in the order other, this, this,
   other (each imports its own package and its own chip_smoke.py):
   every call through that checkout's `_expand_from_enc` and
   `distinct_step` with its chip_smoke's `measure_k9` and
   `measure_distinct` (against the plain version, timed around the
   call, and one torch.unique(dim=0) of the fold's live rows), on the
   device (chip_smoke.graph_device_us: ten calls in a CUDA graph,
   replayed) and on the host (chip_smoke.host_ms); before them the
   DISTINCT and UNION queries, cold and then three times warm, in a
   fresh runner (the checkout's kernels built first, so no nvcc time
   is in a wall); after them the fold at two synthetic shapes: that of
   DISTINCT's largest fold, and 4,194,304 rows, whose K33 table (2^23
   words, 64 MB) is past the H100's 50 MB L2.

Each measurement prints one JSON line (also appended to --out); the
script imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: the role of the largest general K9 call, beside EXPAND_AT's
LARGEST = ("largest", "general")


def emit(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def own(torch, obj):
    """`obj` with every tensor in it cloned into storage of its own:
    torch.save cannot save views of one allocation under several dtypes
    (the outputs of K9 and K33)."""
    import dataclasses
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, (tuple, list)):
        return type(obj)(own(torch, x) for x in obj)
    if isinstance(obj, dict):
        return {k: own(torch, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: own(torch, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def capture(work: Path, out):
    import torch
    import chip_smoke as smoke
    from presto_tpu_torch.native import cuda
    from presto_tpu_torch.ops import join as tj
    from presto_tpu_torch.ops import sort as tsort
    from presto_tpu_torch.runner import LocalRunner
    cuda.build()
    calls = {"k9": {}, "distinct": None}
    state = {"query": None}
    expand, distinct = tj._expand_from_enc, tsort.distinct_step

    def rec_expand(table, probe, *args):
        cap, join_type = args[2], args[3]
        if join_type != "full":
            layout = "aligned" if tj._aligned_layout(
                table, probe, cap, join_type) else "general"
            # each role kept: the most output slots its call may have
            limits = {LARGEST: 1 << 62} if layout == "general" else {}
            key = (state["query"], layout)
            if key in smoke.EXPAND_AT:
                limits[key] = smoke.EXPAND_AT[key][1]
            for key, most in limits.items():
                if most >= cap > calls["k9"].get(key, (0,))[0]:
                    calls["k9"][key] = (cap, state["query"],
                                        (table, probe, *args))
        return expand(table, probe, *args)

    def rec_distinct(st, batch):
        rows = st.capacity + batch.capacity
        if rows > (calls["distinct"] or (0,))[0]:
            calls["distinct"] = (rows, state["query"], (st, batch))
        return distinct(st, batch)
    tj._expand_from_enc, tsort.distinct_step = rec_expand, rec_distinct
    runners = {}
    try:
        for label, kernels in smoke.MUST.items():
            if not {"join_expand", "distinct_set"} & set(kernels):
                continue
            state["query"] = label
            schema = smoke.QUERY_SCHEMA.get(label, "sf1")
            if schema not in runners:
                runners[schema] = LocalRunner("tpch", schema,
                                              properties=smoke.PROPS)
            t = time.perf_counter()
            runners[schema].execute(smoke.QUERIES[label]).rows()
            emit({"phase": "capture", "query": label,
                  "s": time.perf_counter() - t}, out)
    finally:
        tj._expand_from_enc, tsort.distinct_step = expand, distinct
    torch.cuda.synchronize()
    missing = [k for k in [LARGEST, *smoke.EXPAND_AT]
               if k not in calls["k9"]]
    if missing or calls["distinct"] is None:
        raise SystemExit(f"calls not captured: {missing}")
    torch.save(own(torch, calls), work / "calls.pt")
    emit({"phase": "captured",
          "k9": {f"{q}/{lay}": [c[0], c[1]]
                 for (q, lay), c in calls["k9"].items()},
          "distinct": [calls["distinct"][0], calls["distinct"][1]]}, out)


def synthetic_fold(torch, tb, tt, state_rows, batch_rows, dev):
    """A DISTINCT-shaped fold (two BIGINT keys, no NULLs): a state of
    `state_rows` slots three quarters live, and a batch of `batch_rows`
    rows half of which repeat state rows."""
    gen = torch.Generator(device=dev).manual_seed(16)
    live = state_rows * 3 // 4

    def col(x):
        return tb.Column(x, torch.ones_like(x, dtype=torch.bool), tt.BIGINT)
    a = torch.randint(0, 1 << 40, (state_rows,), device=dev, generator=gen)
    b = torch.arange(state_rows, device=dev)
    valid = torch.arange(state_rows, device=dev) < live
    state = tb.Batch({"a": col(a), "b": col(b)}, valid)
    pick = torch.randint(0, live, (batch_rows,), device=dev, generator=gen)
    fresh = torch.rand(batch_rows, device=dev, generator=gen) < 0.5
    ba = torch.where(fresh, torch.randint(0, 1 << 40, (batch_rows,),
                                          device=dev, generator=gen), a[pick])
    bb = torch.where(fresh, -1 - torch.arange(batch_rows, device=dev),
                     b[pick])
    batch = tb.Batch({"a": col(ba), "b": col(bb)},
                     torch.ones(batch_rows, dtype=torch.bool, device=dev))
    return state, batch


def measure(work: Path, out, label: str):
    # the checkout measured is the working directory: its package and
    # its chip_smoke.py, not the ones beside this script
    sys.path[:] = [os.getcwd()] + [p for p in sys.path
                                   if Path(p or ".").resolve() != HERE]
    import torch
    import chip_smoke as smoke
    from presto_tpu_torch import batch as tb
    from presto_tpu_torch import types as tt
    from presto_tpu_torch.native import cuda
    from presto_tpu_torch.ops import join as tj
    from presto_tpu_torch.ops import sort as tsort
    from presto_tpu_torch.runner import LocalRunner
    t = time.perf_counter()
    cuda.build()
    emit({"phase": "build", "checkout": label,
          "s": time.perf_counter() - t}, out)
    # the walls first, in a process that has run nothing else: cold,
    # then the median of three warm executions
    runner = LocalRunner("tpch", "sf1", properties=smoke.PROPS)
    for q in ("distinct", "union"):
        walls = []
        for _ in range(4):
            t = time.perf_counter()
            runner.execute(smoke.QUERIES[q]).rows()
            walls.append(time.perf_counter() - t)
        emit({"phase": "wall", "checkout": label, "query": q,
              "cold_s": walls[0], "warm_s": sorted(walls[1:])[1],
              "warm_runs_s": walls[1:]}, out)
    del runner
    calls = torch.load(work / "calls.pt", weights_only=False)
    for key, (cap, q_from, k9_args) in calls["k9"].items():
        m = smoke.measure_k9(torch, tj, k9_args, {})
        if "device_us" not in m:
            m["device_us"] = smoke.graph_device_us(
                torch, lambda: tj._expand_from_enc(*k9_args, None))
        m["host_ms"] = smoke.host_ms(
            torch, lambda: tj._expand_from_enc(*k9_args, None))
        emit({"phase": "join_expand", "checkout": label,
              "role": "largest general call" if key == LARGEST
              else f"{key[0]} {key[1]}", "slots": cap, "shape_from": q_from,
              **m}, out)
    rows, query, args = calls["distinct"]
    fold = lambda: tsort.distinct_step(*args)  # noqa: E731
    m = smoke.measure_distinct(torch, tsort, args)
    if "device_us" not in m:
        try:
            m["device_us"] = smoke.graph_device_us(torch, fold)
        except Exception as e:  # a fold that cannot be captured
            m["device_us"] = None
            m["device_us_error"] = repr(e)[:300]
    m["host_ms"] = smoke.host_ms(torch, fold)
    emit({"phase": "distinct", "checkout": label, "shape_from": query,
          **m}, out)
    for name, (s_rows, b_rows) in (("same shape", (1 << 19, 1 << 18)),
                                   ("table past the L2",
                                    (1 << 21, 1 << 21))):
        st, b = synthetic_fold(torch, tb, tt, s_rows, b_rows,
                               torch.device("cuda"))
        fn = lambda: tsort.distinct_step(st, b)  # noqa: E731
        # the same set of rows as the plain version (each checkout's
        # layout is its own)
        got, want = (torch.stack([x.columns[k].data[x.row_valid]
                                  for k in ("a", "b")], 1)
                     for x in (fn(), tsort.distinct_step_plain(st, b)))
        smoke.check(got.shape == want.shape and torch.equal(
            torch.unique(got, dim=0), torch.unique(want, dim=0)),
            "the fold at a synthetic shape differs from its plain version")
        n = s_rows + b_rows
        us = smoke.graph_device_us(torch, fn)
        emit({"phase": "distinct_synthetic", "checkout": label,
              "role": name, "rows": n, "ms": smoke.time_ms(fn, torch),
              "device_us": us, "ns_per_row": us * 1e3 / n}, out)
        del st, b


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the other checkout's directory")
    ap.add_argument("--work", default=str(HERE / "presto_tpu_torch" / "_build"
                                         / "kernel_ab"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--step", choices=("capture", "measure"))
    ap.add_argument("--label", default="this")
    a = ap.parse_args()
    work = Path(a.work)
    work.mkdir(parents=True, exist_ok=True)
    if a.step == "capture":
        capture(work, a.out)
        return 0
    if a.step == "measure":
        measure(work, a.out, a.label)
        return 0
    if not a.other:
        ap.error("--other is required")
    other = Path(a.other).resolve()
    me = [sys.executable, str(HERE / "kernel_ab.py"), "--work", str(work)]
    if a.out:
        me += ["--out", str(Path(a.out).resolve())]
    subprocess.run(me + ["--step", "capture"], cwd=HERE, check=True)
    for label, tree in (("other", other), ("this", HERE), ("this", HERE),
                        ("other", other)):
        subprocess.run(me + ["--step", "measure", "--label", label],
                       cwd=tree, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
