"""Build and load the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is one kernel with a plain C entry point.
It is compiled with `nvcc` for Hopper (`sm_90a`) into its own shared
library under `presto_tpu_torch/_build/`, named by a hash of its
source and of the shared device headers (`csrc/*.cuh`) so an edited
kernel never loads a stale build, and loaded with `ctypes`. Nothing
here runs at import: the CPU tests import every module of the package
on machines with no `nvcc`.

Calling convention of every entry point: device pointers and the
CUDA stream are passed as `void*`, sizes as 64-bit integers, host
arrays of device addresses as `void*` to int64 arrays, and the
function returns `cudaGetLastError()` after its launches, which
`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: kernel family -> source file under csrc/
SOURCES = {
    "slot_reduce": "slot_reduce.cu",
    "compact": "compact.cu",
    "row_hash": "row_hash.cu",
    "join_build": "join_build.cu",
    "join_probe": "join_probe.cu",
    "segment_reduce": "segment_reduce.cu",
    "semi_join": "semi_join.cu",
    "stream_reduce": "stream_reduce.cu",
    "join_expand": "join_expand.cu",
    "cross_product": "cross_product.cu",
    "join_outer": "join_outer.cu",
    "window_segments": "window_segments.cu",
    "window_frame_sum": "window_frame_sum.cu",
    "window_frame_minmax": "window_frame_minmax.cu",
    "window_emit": "window_emit.cu",
    "array_collect": "array_collect.cu",
    "exchange_shuffle": "exchange_shuffle.cu",
    "merge_pair": "merge_pair.cu",
    "exchange_partition": "exchange_partition.cu",
    "dynamic_filter": "dynamic_filter.cu",
    "sort_encode": "sort_encode.cu",
    "radix_sort": "radix_sort.cu",
    "gather_rows": "gather_rows.cu",
    "limit_rank": "limit_rank.cu",
    "state_shrink": "state_shrink.cu",
    "agg_finalize": "agg_finalize.cu",
    "vector_reduce": "vector_reduce.cu",
}

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_U64 = ctypes.c_uint64
#: C entry points per family: name -> (restype, argtypes). Pointer
#: arrays (host arrays of device addresses) are passed as void*.
SIGNATURES = {
    "slot_reduce": {
        "presto_direct_slot_reduce": (
            ctypes.c_int, [_P, _P, _P, _I32, _P, _I64, _P, _P, _P, _P,
                           _I32, _P, _I32, _P]),
    },
    "compact": {
        "presto_compact_tiles": (ctypes.c_int, [_I64]),
        "presto_compact": (
            ctypes.c_int, [_P, _P, _P, _P, _P, _I32, _P, _P, _I64, _I64,
                           _I32, _P, _P]),
    },
    "row_hash": {
        "presto_row_hash": (
            ctypes.c_int, [_P, _P, _P, _I32, _I32, _P, _P, _I32, _P, _P,
                           _P]),
    },
    "join_build": {
        "presto_join_build": (
            ctypes.c_int, [_P, _I64, _I32, _P, _P, _P, _P]),
    },
    "join_probe": {
        "presto_join_probe": (
            ctypes.c_int, [_P, _P, _P, _I32, _P, _I64, _P, _P, _P, _I32,
                           _I32, _P, _P, _P]),
    },
    "segment_reduce": {
        "presto_segment_tile": (ctypes.c_int, []),
        "presto_segment_key_changes": (
            ctypes.c_int, [_P, _P, _P, _I32, _I64, _P, _P]),
        "presto_segment_reduce": (
            ctypes.c_int, [_P, _P, _P, _P, _P, _I32, _P, _P, _I64, _P, _P,
                           _P, _P, _I32, _I64, _P, _P, _P, _P, _P, _P]),
    },
    "semi_join": {
        "presto_semi_join": (
            ctypes.c_int, [_P, _P, _P, _I32, _P, _I64, _P, _P, _P, _P, _I32,
                           _I32, _P, _P, _P, _I32, _P, _P]),
    },
    "stream_reduce": {
        "presto_stream_tile": (ctypes.c_int, []),
        "presto_stream_reduce": (
            ctypes.c_int, [_P, _P, _P, _I32, _P, _I64, _P, _P, _P, _P, _I32,
                           _I64, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P]),
    },
    "join_expand": {
        "presto_expand_tile": (ctypes.c_int, []),
        "presto_join_expand": (
            ctypes.c_int, [_I32, _P, _P, _I64, _P, _P, _P, _I64, _I32, _I32,
                           _P, _P, _P, _P, _P, _P, _I32, _P, _P, _P, _P, _P,
                           _P, _I32, _P, _I64, _P, _P, _P, _P]),
    },
    "cross_product": {
        "presto_cross_product": (
            ctypes.c_int, [_I64, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P,
                           _I32, _P, _I64, _P]),
    },
    "join_outer": {
        "presto_join_outer": (
            ctypes.c_int, [_P, _P, _I64, _P, _P, _P, _P, _P, _P, _I32, _P,
                           _P, _P]),
    },
    "window_segments": {
        "presto_window_tile": (ctypes.c_int, []),
        "presto_window_key_changes": (
            ctypes.c_int, [_P, _P, _P, _I32, _I64, _I32, _P, _P]),
        "presto_window_segments": (
            ctypes.c_int, [_P, _P, _I64, _I32, _I32, _P, _P, _P, _P, _P, _P,
                           _P, _P]),
    },
    "window_frame_sum": {
        "presto_window_tile": (ctypes.c_int, []),
        "presto_window_frame_sum": (
            ctypes.c_int, [_P, _P, _P, _I32, _P, _P, _I32, _P, _P, _P, _P,
                           _P, _P]),
    },
    "window_frame_minmax": {
        "presto_window_frame_minmax": (
            ctypes.c_int, [_P, _P, _P, _I32, _I32, _P, _P, _P, _P, _P, _P,
                           _I64, _I32, _P, _P, _P]),
    },
    "window_emit": {
        "presto_window_emit": (ctypes.c_int, [_P, _P, _P, _P, _I32, _P]),
    },
    "array_collect": {
        "presto_collect_max_specs": (ctypes.c_int, []),
        "presto_array_collect": (
            ctypes.c_int, [_P] * 13 + [_I32, _P, _P, _I64, _I64, _I64, _I64,
                                       _I32, _P, _P, _P, _P]),
    },
    "exchange_shuffle": {
        "presto_wave_max_workers": (ctypes.c_int, []),
        "presto_wave_max_cols": (ctypes.c_int, []),
        "presto_wave_block_rows": (ctypes.c_int, []),
        "presto_wave_count": (
            ctypes.c_int, [_P, _I32, _I64, _P, _P, _P, _P]),
        "presto_wave_scatter": (
            ctypes.c_int, [_P, _P, _I32, _I32, _I64, _P, _P, _I32, _I32,
                           _I32, _I64, _P]),
    },
    "merge_pair": {
        "presto_merge_max_keys": (ctypes.c_int, []),
        "presto_merge_max_cols": (ctypes.c_int, []),
        "presto_merge_pair": (
            ctypes.c_int, [_P] * 7 + [_I32, _P, _I64, _P, _I64] + [_P] * 7
            + [_I32, _P, _I32, _P]),
    },
    "exchange_partition": {
        "presto_partition_max_consumers": (ctypes.c_int, []),
        "presto_partition_block_rows": (ctypes.c_int, []),
        "presto_exchange_partition": (
            ctypes.c_int, [_P, _P, _I64, _I32, _I64, _P, _P, _P, _P, _I32,
                           _P, _P]),
    },
    "dynamic_filter": {
        "presto_df_set_max": (ctypes.c_int, []),
        "presto_df_table_slots": (ctypes.c_int, []),
        "presto_distinct_set": (
            ctypes.c_int, [_P, _P, _I64, _I32, _P, _P, _P, _P, _P, _P]),
        "presto_apply_filter": (
            ctypes.c_int, [_P, _P, _P, _I64, _I32, _I32, _P, _P, _P, _P,
                           _I32, _P, _P]),
    },
    "sort_encode": {
        "presto_sort_max_keys": (ctypes.c_int, []),
        "presto_sort_max_words": (ctypes.c_int, []),
        "presto_sort_encode": (
            ctypes.c_int, [_P] * 10 + [_I32, _P, _P, _I32, _I32, _I64, _I64,
                                       _P, _P, _P, _P]),
    },
    "radix_sort": {
        "presto_radix_tile": (ctypes.c_int, []),
        "presto_radix_sort": (
            ctypes.c_int, [_P, _I32, _I64, _U64, _P, _I32, _P, _P, _P, _P,
                           _P, _P, _P]),
    },
    "gather_rows": {
        "presto_gather_max_arrays": (ctypes.c_int, []),
        "presto_gather_rows": (
            ctypes.c_int, [_P, _I32, _P, _P, _P, _P, _P, _I32, _P, _I64, _P,
                           _P, _P]),
    },
    "limit_rank": {
        "presto_limit_tiles": (ctypes.c_int, [_I64]),
        "presto_limit_rank": (
            ctypes.c_int, [_P, _I64, _I64, _P, _P, _P, _P, _P, _P]),
    },
    "state_shrink": {
        "presto_state_shrink": (ctypes.c_int, [_P, _P, _P, _I32, _P]),
    },
    "agg_finalize": {
        "presto_agg_finalize": (
            ctypes.c_int, [_P, _I32, _I64, _I64, _P, _P]),
    },
    "vector_reduce": {
        "presto_vector_direct": (
            ctypes.c_int, [_P, _P, _P, _I32, _P, _I64, _P, _P, _P, _I32,
                           _I32, _I32, _I32, _P, _P]),
        "presto_vector_segments": (
            ctypes.c_int, [_P, _P, _P, _P, _I32, _P, _P, _P, _P, _I64, _P,
                           _I64, _I32, _I32, _I32, _I32, _I32, _P, _P, _P,
                           _P]),
    },
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                          "PATH): the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    # the shared headers are part of every source's identity
    src = (CSRC / SOURCES[name]).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one `nvcc`
    process per source, all started together. Returns seconds per
    kernel (0.0 for one already built). Raises with nvcc's output when
    a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    secs = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise KernelError("\n".join(errors))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel family `name`, built on
    first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            lib.presto_error_string.restype = ctypes.c_char_p
            lib.presto_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise when a C entry point of `lib` returned a CUDA error."""
    if status != 0:
        msg = lib.presto_error_string(status).decode()
        raise KernelError(f"{what}: CUDA error {status}: {msg}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
