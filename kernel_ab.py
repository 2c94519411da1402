#!/usr/bin/env python3
"""Time kernel families of the port in this checkout beside another
checkout of the repository (its parent commit, say) on one NVIDIA GPU,
on the same calls captured from the main path:

    python3 kernel_ab.py --kernels FAMILY[,FAMILY...] [--other DIR]
        [--walls QUERY,...] [--variants FAMILY:NAME=V[,NAME=V...][;...]]
        [--work DIR] [--out FILE]

The families are the keys of chip_smoke.py's AB_CALLS table (the
launch counters' names: segment_reduce, compact, ...).

1. Capture (one process, this checkout): the queries that chip_smoke's
   MUST table says launch any of the families go through LocalRunner
   at chip_smoke's schemas and properties inside chip_smoke's Capture;
   each family's AB_CALLS entry picks its calls from what the Capture
   kept (and any it builds itself), and they are saved with torch.save.
2. Measure, one process per checkout in the order other, this, this,
   other (each imports its own package and its own chip_smoke.py; the
   table is this checkout's): first the walls of the --walls queries
   (by default the captured ones), cold and then three times warm, in a
   fresh runner (the checkout's kernels built first, so no nvcc time is
   in a wall); then every call through the checkout's own measure_*
   (against the plain version, timed around the call, beside the
   library call), with its device µs (chip_smoke.graph_device_us: ten
   calls in a CUDA graph, replayed), host ms (chip_smoke.host_ms) and
   CUDA launches a call (chip_smoke.launches_of) where the measure_*
   does not report them itself.
3. With --variants, this checkout alone: each variant is a family's
   source built with the macros it names defined (`nvcc -DNAME=V`; one
   nvcc a variant, all started together), loaded in place of the
   family's library, and timed at the family's calls as in step 2.

Each measurement prints one JSON line (also appended to --out); the
script imports nothing of JAX.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def emit(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def own(torch, obj):
    """`obj` with every tensor in it cloned into storage of its own
    (torch.save cannot save views of one allocation under several
    dtypes, as the outputs of several kernels are)."""
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


def table():
    """This checkout's chip_smoke.py, loaded under a name of its own (the
    measured checkout's is `chip_smoke`)."""
    spec = importlib.util.spec_from_file_location("kernel_ab_table",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def queries_of(smoke, families):
    """The queries MUST says launch any of `families`, in its order."""
    return [q for q, ks in smoke.MUST.items() if set(ks) & set(families)]


def capture(work: Path, out, families):
    import numpy as np
    import torch
    import chip_smoke as smoke
    mods = smoke.port_modules()
    mods["cuda"].build()
    dev = torch.device("cuda")
    runners = {}
    with smoke.Capture(mods) as cap:
        for q in queries_of(smoke, families):
            schema = smoke.QUERY_SCHEMA.get(q, smoke.SCHEMA)
            if schema not in runners:
                runners[schema] = mods["LocalRunner"](
                    "tpch", schema, properties=smoke.PROPS)
            t = time.perf_counter()
            cap.run(q, lambda: runners[schema].execute(
                smoke.QUERIES[q]).rows())
            emit({"phase": "capture", "query": q,
                  "s": time.perf_counter() - t}, out)
    calls = {f: smoke.AB_CALLS[f][0](torch, np, mods, cap, dev,
                                     smoke.SCHEMA)
             for f in families}
    torch.save(own(torch, calls), work / "calls.pt")
    emit({"phase": "captured", "calls": {f: sorted(c)
                                         for f, c in calls.items()}}, out)


def measure_calls(torch, smoke, spec, mods, calls, families, out, **tags):
    """Every saved call of `families` through the measured checkout's
    measure_*, completed with device µs, host ms and launches a call."""
    for family in families:
        _, call, measure_one = spec.AB_CALLS[family]
        for role, args in calls[family].items():
            m = measure_one(smoke, torch, mods, role, args)
            fn = call(mods, args)
            if "device_us" not in m:
                m["device_us"] = smoke.graph_device_us(torch, fn)
            if "host_ms" not in m:
                m["host_ms"] = smoke.host_ms(torch, fn)
            if "launches_per_call" not in m:
                m["launches_per_call"] = smoke.launches_of(torch, fn)
            emit({"phase": family, **tags, "role": role, **m}, out)


def measure(work: Path, out, label: str, families, walls):
    # the checkout measured is the working directory: its package and
    # its chip_smoke.py, not the ones beside this script
    sys.path[:] = [os.getcwd()] + [p for p in sys.path
                                   if Path(p or ".").resolve() != HERE]
    import torch
    import chip_smoke as smoke
    spec = table()
    mods = spec.port_modules()
    t = time.perf_counter()
    mods["cuda"].build()
    emit({"phase": "build", "checkout": label,
          "s": time.perf_counter() - t}, out)
    runner = mods["LocalRunner"]("tpch", smoke.SCHEMA,
                                 properties=smoke.PROPS)
    for q in walls:
        times = []
        for _ in range(4):
            t = time.perf_counter()
            runner.execute(smoke.QUERIES[q]).rows()
            times.append(time.perf_counter() - t)
        emit({"phase": "wall", "checkout": label, "query": q,
              "cold_s": times[0], "warm_s": sorted(times[1:])[1],
              "warm_runs_s": times[1:]}, out)
    del runner
    calls = torch.load(work / "calls.pt", weights_only=False)
    measure_calls(torch, smoke, spec, mods, calls, families, out,
                  checkout=label)


def parse_variants(text):
    """[(family, (NAME=V, ...)), ...] of --variants."""
    out = []
    for item in filter(None, (text or "").split(";")):
        family, _, defines = item.partition(":")
        out.append((family, tuple(d for d in defines.split(",") if d)))
    return out


def variants(work: Path, out, text):
    import ctypes
    import torch
    import chip_smoke as smoke
    mods = smoke.port_modules()
    cuda = mods["cuda"]
    cuda.build()
    procs = []
    for k, (family, defines) in enumerate(parse_variants(text)):
        so = work / f"{family}-variant{k}-{os.getpid()}.so"
        procs.append((family, defines, so, subprocess.Popen(
            [cuda.nvcc_path(), *cuda.NVCC_FLAGS,
             *[f"-D{d}" for d in defines], "-o", str(so),
             str(cuda.CSRC / cuda.SOURCES[family])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for family, defines, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {family} {defines}: {log}")
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in cuda.SIGNATURES[family].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        lib.presto_error_string.restype = ctypes.c_char_p
        lib.presto_error_string.argtypes = [ctypes.c_int]
        libs.append((family, defines, lib))
    calls = torch.load(work / "calls.pt", weights_only=False)
    for family, defines, lib in libs:
        real = cuda.library(family)
        cuda._libs[family] = lib
        try:
            measure_calls(torch, smoke, smoke, mods, calls, [family], out,
                          checkout="this", variant=",".join(defines))
        finally:
            cuda._libs[family] = real


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", required=True,
                    help="comma-separated families of chip_smoke's "
                    "AB_CALLS")
    ap.add_argument("--other", help="the other checkout's directory")
    ap.add_argument("--walls", default=None,
                    help="comma-separated queries of chip_smoke's QUERIES "
                    "(default: the captured ones; '' for none)")
    ap.add_argument("--work", default=str(HERE / "presto_tpu_torch" / "_build"
                                         / "kernel_ab"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--variants", default=None,
                    help="FAMILY:NAME=V[,NAME=V...] builds of this "
                    "checkout's sources, ';'-separated")
    ap.add_argument("--step", choices=("capture", "measure", "variants"))
    ap.add_argument("--label", default="this")
    a = ap.parse_args()
    families = [f for f in a.kernels.split(",") if f]
    spec = table()
    extra = [f for f, _ in parse_variants(a.variants)]
    unknown = set(families + extra) - set(spec.AB_CALLS)
    if unknown:
        ap.error(f"no AB_CALLS entry for {sorted(unknown)}; chip_smoke.py "
                 f"has {sorted(spec.AB_CALLS)}")
    walls = queries_of(spec, families) if a.walls is None \
        else [q for q in a.walls.split(",") if q]
    work = Path(a.work)
    work.mkdir(parents=True, exist_ok=True)
    if a.step == "capture":
        capture(work, a.out, families)
        return 0
    if a.step == "measure":
        measure(work, a.out, a.label, families, walls)
        return 0
    if a.step == "variants":
        variants(work, a.out, a.variants)
        return 0
    if set(extra) - set(families):
        ap.error("a variant's family must be one of --kernels")
    me = [sys.executable, str(HERE / "kernel_ab.py"), "--work", str(work),
          "--kernels", a.kernels, "--walls", ",".join(walls)]
    if a.out:
        me += ["--out", str(Path(a.out).resolve())]
    subprocess.run(me + ["--step", "capture"], cwd=HERE, check=True)
    order = (("this", HERE),) if not a.other else (
        ("other", Path(a.other).resolve()), ("this", HERE), ("this", HERE),
        ("other", Path(a.other).resolve()))
    for label, tree in order:
        subprocess.run(me + ["--step", "measure", "--label", label],
                       cwd=tree, check=True)
    if a.variants:
        subprocess.run(me + ["--step", "variants", "--variants",
                             a.variants], cwd=HERE, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
