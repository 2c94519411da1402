"""Equi-join kernels with a radix-partitioned probe (reference:
presto_tpu/ops/join.py; HashBuilderOperator.java:51,
LookupJoinOperator.java:53).

No pointer-chasing hash table: the build side is sorted by its 64-bit
key hash once, and `build_for_backend` records where each top-k-bit
hash bucket starts in that order (`part_starts`, ~one bucket per build
row), the length of every equal-hash run (`run_len`) and a second,
independent hash (`hash2`). A probe row hashes its keys, reads its
bucket's bounds, searches only that bucket for the lower bound of its
hash, and confirms the candidate with `hash2` (verify="hash": the pair
is a 128-bit fingerprint, see docs/JOIN_KERNEL.md) or by comparing
every key column (verify="full").

The hand-written CUDA kernels of this module:

- K3 `common.row_hash_pair` (csrc/row_hash.cu) hashes the build keys;
- K25 `common.radix_sort` (csrc/radix_sort.cu) sorts the build rows
  by hash and K26 `common.gather_rows` (csrc/gather_rows.cu) moves
  their columns in one launch (the reference sorts with `jax.lax.sort`
  or a host `np.argsort`);
- K4 `build_meta` (csrc/join_build.cu) derives part_starts, run_len
  and the build's statistics from the sorted hashes;
- K5 `probe_search` (csrc/join_probe.cu) hashes the probe keys with
  the same device code and searches the build;
- K9 `_expand_from_enc` (csrc/join_expand.cu) expands the search's
  candidates into the output slots, in one of two layouts:
  - ALIGNED, when every build hash run has length 1 (`unique_runs`,
    any FK->PK join) and the output capacity is the probe capacity:
    output slot i is probe row i, the build side one gather per column
    (one launch);
  - GENERAL, for duplicate-key builds: each probe row's first slot
    from a scan of its emit counts, then a write in which each block
    owns a run of rows and slots and consecutive threads write
    consecutive slots, into a caller-chosen capacity, with an
    on-device overflow flag (two launches).

Each has a plain PyTorch version beside it, which runs for CPU tensors.

Join types: inner, left and full (a right join is planned as a flipped
left join). A FULL join probes as a left join does and besides folds
every verified match into running per-build-row `matched` flags (K9's
full mode, `probe_join_full`); after the last probe batch, K11
`unmatched_build` (csrc/join_outer.cu) emits the build rows no probe
row matched, with a NULL probe side.
"""

from __future__ import annotations

import array
import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.ops import common
from presto_tpu_torch.telemetry import kernels as _tk

CVal = Tuple[torch.Tensor, torch.Tensor]

#: bucket-per-row radix: k ~ log2(build size), capped so part_starts
#: (8 bytes per bucket) stays the order of the build itself
MAX_RADIX_BITS = 18
#: builds at or below this size skip partitioning (k = 0)
MIN_RADIX_ROWS = 1024

#: "hash" confirms a candidate by the second hash, "full" by comparing
#: every key column (the collision fallback and the tests' oracle)
VERIFY_MODES = ("hash", "full")

#: the join types of the probe (a right join is a flipped left join)
JOIN_TYPES = ("inner", "left", "full")

_H_INVALID = common.H_INVALID
_H2_INVALID = common.H2_INVALID


@dataclasses.dataclass
class BuildTable:
    """Sorted-by-hash build side, ready for probing. `batch` rows are in
    sorted-hash order, so a candidate at sorted slot s is batch row s."""
    sorted_hash: torch.Tensor       # [n] int64, dead rows at the end
    hash2: torch.Tensor             # [n] int64 second hash (verify)
    part_starts: torch.Tensor       # [2^k + 1] int64 bucket offsets
    run_len: torch.Tensor           # [n] int64: run length at run starts
    valid_count: torch.Tensor       # scalar: live build rows
    batch: Batch                    # build rows, sorted by key hash
    radix_bits: int = 0             # k (0 = whole-table search)
    search_depth: int = 64          # levels the plain search runs
    unique_runs: bool = False       # every live run has length 1

    def __post_init__(self):
        # the probe kernels (K5, K7) read these arrays as they lie: they
        # are checked once, here, and not on every probe
        dev = self.sorted_hash.device
        nb = self.sorted_hash.shape[0] if self.sorted_hash.dim() == 1 else -1
        nparts = (1 << self.radix_bits) + 1 if self.radix_bits else 2
        for t, rows, what in ((self.sorted_hash, nb, "sorted_hash"),
                              (self.hash2, nb, "hash2"),
                              (self.run_len, nb, "run_len"),
                              (self.part_starts, nparts, "part_starts")):
            common.check_rows(t, rows, dev, (torch.int64,),
                              f"BuildTable: {what}")


def choose_radix_bits(capacity: int) -> int:
    """k from the build size: one bucket per expected row, capped."""
    if capacity <= MIN_RADIX_ROWS:
        return 0
    return max(1, min(int(math.ceil(math.log2(capacity))),
                      MAX_RADIX_BITS))


@functools.lru_cache(maxsize=None)
def _partition_bounds_np(k: int) -> np.ndarray:
    """The 2^k signed-int64 bucket boundary values: the signed value
    (p - half) << (64 - k) has the bits of (p XOR half) << (64 - k)."""
    half = np.uint64(1 << (k - 1))
    p = np.arange(1 << k, dtype=np.uint64)
    return ((p ^ half) << np.uint64(64 - k)).view(np.int64)


def _partition_of(h: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k-bit bucket id in [0, 2^k): an ARITHMETIC shift of the
    signed hash, so bucket order is signed sort order."""
    return (h >> (64 - k)) + (1 << (k - 1))


def _key_valid(batch: Batch, key_names: Sequence[str]) -> torch.Tensor:
    valid = batch.row_valid
    for k in key_names:
        valid = valid & batch.columns[k].mask
    return valid


def _hash_batch(batch: Batch, key_names: Tuple[str, ...]):
    """(h, h2, valid) of the build keys, dead rows on their sentinels
    (K3 on CUDA)."""
    keys = [batch.columns[k].astuple() for k in key_names]
    h, h2 = common.row_hash_pair(keys, batch.row_valid, True)
    return h, h2, _key_valid(batch, key_names)


# -- K4: the build's radix metadata -------------------------------------


#: launches of the CUDA join-build kernel (csrc/join_build.cu)
JOIN_BUILD_KERNEL = _tk.LaunchCounter("join_build")


def build_meta_plain(sh: torch.Tensor, k: int):
    """Plain version of K4 over sorted hashes `sh` (the reference's CPU
    branch, :280-310): (part_starts [2^k + 1], run_len [n], stats [3] =
    first dead row, largest bucket span, longest live run)."""
    n = sh.shape[0]
    dev = sh.device
    fi = int(torch.searchsorted(
        sh, torch.tensor([_H_INVALID], dtype=torch.int64, device=dev))[0])
    if k > 0:
        counts = torch.bincount(_partition_of(sh, k), minlength=1 << k)
        part_starts = torch.zeros((1 << k) + 1, dtype=torch.int64,
                                  device=dev)
        part_starts[1:] = torch.cumsum(counts, 0)
    else:
        part_starts = torch.tensor([0, n], dtype=torch.int64, device=dev)
    part_starts = torch.clamp(part_starts, max=fi)
    max_span = int(torch.diff(part_starts).max()) if n else 0
    run_len = torch.zeros(n, dtype=torch.int64, device=dev)
    max_run = 0
    if n:
        head = torch.ones(n, dtype=torch.bool, device=dev)
        head[1:] = sh[1:] != sh[:-1]
        starts = torch.nonzero(head).flatten()
        ends = torch.cat([starts[1:], starts.new_tensor([n])])
        run_len[starts] = ends - starts
        live = starts < fi
        if bool(live.any()):
            max_run = int((torch.clamp(ends, max=fi) - starts)[live].max())
    stats = torch.tensor([fi, max_span, max_run], dtype=torch.int64,
                         device=dev)
    return part_starts, run_len, stats


def _build_meta_cuda(sh: torch.Tensor, k: int):
    from presto_tpu_torch.native import cuda
    dev = sh.device
    n = sh.shape[0]
    common.check_rows(sh, n, dev, (torch.int64,), "join_build: hashes")
    if not 0 <= k <= MAX_RADIX_BITS:
        raise ValueError(f"join_build: radix bits {k}")
    part_starts = torch.empty((1 << k) + 1 if k else 2,
                              dtype=torch.int64, device=dev)
    run_len = torch.empty(n, dtype=torch.int64, device=dev)
    stats = torch.empty(3, dtype=torch.int64, device=dev)
    lib = cuda.library("join_build")
    status = lib.presto_join_build(
        ctypes.c_void_p(sh.data_ptr()), ctypes.c_int64(n),
        ctypes.c_int32(k), ctypes.c_void_p(part_starts.data_ptr()),
        ctypes.c_void_p(run_len.data_ptr()),
        ctypes.c_void_p(stats.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "join_build")
    JOIN_BUILD_KERNEL.launches += 1
    return part_starts, run_len, stats


def build_meta(sh: torch.Tensor, k: int):
    """K4: the radix metadata of sorted build hashes (see
    `build_meta_plain`). The CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if sh.device.type == "cpu":
        return build_meta_plain(sh, k)
    return _build_meta_cuda(sh, k)


def build_for_backend(batch: Batch, key_names: Tuple[str, ...],
                      radix_bits: Optional[int] = None) -> BuildTable:
    """Index the build side: hash (K3), stable sort by hash (K25, which
    also returns the sorted hashes), radix metadata (K4), then permute
    the columns, row_valid and the second hashes (K26, one launch). The
    statistics come back in the build's one host read, which picks the
    probe layout. `radix_bits` overrides the size-derived k."""
    _tk.count("join_build")
    k = choose_radix_bits(batch.capacity) if radix_bits is None \
        else max(0, min(int(radix_bits), MAX_RADIX_BITS))
    h, h2, _ = _hash_batch(batch, tuple(key_names))
    perm, sh = common.radix_sort([h], flip=True, sorted_first=True)
    part_starts, run_len, stats = build_meta(sh, k)
    names = list(batch.columns)
    moved, svalid = common.gather_rows(
        [([batch.columns[n].astuple() for n in names] + [(h2, None)],
          batch.row_valid)], perm)
    cols = {n: Column(d, m, batch.columns[n].type,
                      batch.columns[n].dictionary)
            for n, (d, m) in zip(names, moved)}
    sbatch = Batch(cols, svalid)
    fi, max_span, max_run = (int(x) for x in stats.tolist())
    return BuildTable(sh, moved[-1][0], part_starts, run_len,
                      stats[0], sbatch, radix_bits=k,
                      search_depth=common.search_iters(max_span),
                      unique_runs=max_run <= 1)


# -- K5: the probe's candidate search ------------------------------------


#: launches of the CUDA probe-search kernel (csrc/join_probe.cu)
JOIN_PROBE_KERNEL = _tk.LaunchCounter("join_probe")


def _probe_hashes(probe: Batch, probe_keys: Tuple[str, ...]):
    """(h, h2) of the probe keys, with the dead-row sentinels folded
    in: a NULL-key or dead probe row matches nothing, because the build
    clipped its sentinel run out of every bucket."""
    keys = [probe.columns[k].astuple() for k in probe_keys]
    return common.row_hash_pair_plain(keys, probe.row_valid, True)


def _search_enc(table: BuildTable, h: torch.Tensor, h2: torch.Tensor,
                verify: str) -> torch.Tensor:
    """Per probe row: the build slot of its candidate run start, or -1.
    For unique-run builds under verify="hash" the second-hash check
    folds in here."""
    n = table.sorted_hash.shape[0]
    k = table.radix_bits
    if k > 0:
        pid = _partition_of(h, k)
        lo0 = table.part_starts[pid]
        hi0 = table.part_starts[pid + 1]
    else:
        lo0 = torch.zeros_like(h)
        hi0 = table.part_starts[-1].expand(h.shape)
    lo = common.bounded_searchsorted(table.sorted_hash, h, lo0, hi0,
                                     table.search_depth, side="left")
    loc = torch.clamp(lo, 0, max(n - 1, 0))
    found = (lo < hi0) & (table.sorted_hash[loc] == h)
    if table.unique_runs and verify == "hash":
        found = found & (table.hash2[loc] == h2)
    return torch.where(found, lo, torch.full_like(lo, -1))


def probe_search_plain(table: BuildTable, probe: Batch,
                       key_names: Tuple[str, ...], verify: str):
    """Plain version of K5: (lo_enc, probe hash2 or None)."""
    h, h2 = _probe_hashes(probe, key_names)
    lo_enc = _search_enc(table, h, h2, verify)
    return lo_enc, None if _search_checks_hash2(table, verify) else h2


def _search_checks_hash2(table: BuildTable, verify: str) -> bool:
    """The search folds the hash2 check in (unique-run build under
    verify="hash"), so no later step needs the probe's hash2."""
    return table.unique_runs and verify == "hash"


def _probe_search_cuda(table: BuildTable, probe: Batch,
                       key_names: Tuple[str, ...], verify: str):
    from presto_tpu_torch.native import cuda
    dev = probe.device
    n = probe.capacity
    common.check_rows(probe.row_valid, n, dev, (torch.bool,),
                      "join_probe: row_valid")
    kd, km, kt, nk, _desc = common.key_group_args(
        [probe.columns[k].astuple() for k in key_names], n, dev,
        "join_probe")
    lo_enc = torch.empty(n, dtype=torch.int64, device=dev)
    checks_h2 = _search_checks_hash2(table, verify)
    h2 = None if checks_h2 else torch.empty(n, dtype=torch.int64,
                                            device=dev)
    lib = cuda.library("join_probe")
    status = lib.presto_join_probe(
        kd, km, kt, nk, probe.row_valid.data_ptr(), n,
        table.sorted_hash.data_ptr(), table.hash2.data_ptr(),
        table.part_starts.data_ptr(), table.radix_bits, int(checks_h2),
        lo_enc.data_ptr(), None if h2 is None else h2.data_ptr(),
        cuda.stream_ptr(dev))
    cuda.check(lib, status, "join_probe")
    JOIN_PROBE_KERNEL.launches += 1
    return lo_enc, h2


def probe_search(table: BuildTable, probe: Batch,
                 key_names: Tuple[str, ...], verify: str = "hash"):
    """K5: per probe row the build slot of its candidate run (-1 for
    none) and the row's hash2, or None where the search already checked
    hash2 (a unique-run build under verify="hash"). The CUDA kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if verify not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {verify!r}")
    if probe.device.type == "cpu":
        return probe_search_plain(table, probe, key_names, verify)
    return _probe_search_cuda(table, probe, key_names, verify)


def probe_counts(table: BuildTable, probe: Batch,
                 probe_keys: Tuple[str, ...]):
    """Per probe row its candidate run [lo, hi) in the sorted build, the
    candidate count (collisions included) and the key validity (the
    reference's `_counts_jit` over a verify="full" search)."""
    lo_enc, _ = probe_search(table, probe, probe_keys, "full")
    found = lo_enc >= 0
    lo = torch.clamp(lo_enc, min=0)
    counts = torch.where(found, table.run_len[lo], torch.zeros_like(lo))
    lo = torch.where(found, lo, torch.zeros_like(lo))
    return lo, lo + counts, counts, _key_valid(probe, probe_keys)


# -- K7: the semi join's mark ----------------------------------------------


#: launches of the CUDA semi-join kernel (csrc/semi_join.cu)
SEMI_JOIN_KERNEL = _tk.LaunchCounter("semi_join", "semi_join")

#: K7's epilogue per build layout and verify mode (csrc/semi_join.cu
#: `SemiMode`)
_SEMI_UNIQUE_HASH, _SEMI_WALK_HASH, _SEMI_WALK_FULL = 0, 1, 2


def _semi_mode(table: BuildTable, verify: str) -> int:
    if verify == "full":
        return _SEMI_WALK_FULL
    return _SEMI_UNIQUE_HASH if table.unique_runs else _SEMI_WALK_HASH


def semi_mark_plain(table: BuildTable, probe: Batch,
                    key_names: Tuple[str, ...],
                    build_keys: Optional[Tuple[str, ...]] = None,
                    verify: str = "hash", negate: bool = False
                    ) -> torch.Tensor:
    """Plain version of K7 (the reference's `semi_mark`: `_semi_resolve`
    for a unique-run build under verify="hash", else `_semi_scan`): the
    keep mask of a semi join, found & valid, or with `negate` (NOT IN /
    NOT EXISTS) ~found & valid, where valid = row_valid and no NULL
    key. A duplicate-run build scans each candidate run to its end."""
    build_keys = tuple(build_keys or key_names)
    keys = [probe.columns[k].astuple() for k in key_names]
    valid = _key_valid(probe, key_names)
    mode = _semi_mode(table, verify)
    lo_enc, _ = probe_search_plain(
        table, probe, key_names,
        "hash" if mode == _SEMI_UNIQUE_HASH else "full")
    if mode == _SEMI_UNIQUE_HASH:
        found = lo_enc >= 0
    else:
        nbuild = table.sorted_hash.shape[0]
        lo = torch.clamp(lo_enc, min=0)
        hi = lo + torch.where(lo_enc >= 0, table.run_len[lo],
                              torch.zeros_like(lo))
        if mode == _SEMI_WALK_HASH:
            h2p = common.row_hash2(keys)
        else:
            bcols = [table.batch.columns[b].astuple() for b in build_keys]
        found = torch.zeros_like(valid)
        i = 0
        # the run scan: a row needs another step while its run extends
        # past offset i and no match has been confirmed (the
        # reference's while_loop)
        while bool((((lo + i) < hi) & valid & ~found).any()):
            brow = torch.clamp(lo + i, 0, max(nbuild - 1, 0))
            same = ((lo + i) < hi) & valid
            if mode == _SEMI_WALK_HASH:
                same = same & (table.hash2[brow] == h2p)
            else:
                for (pd, pm), (bd, bm) in zip(keys, bcols):
                    same = same & (pd == bd[brow]) & pm & bm[brow]
            found = found | same
            i += 1
    found = found & valid
    return (~found & valid) if negate else found


def _semi_mark_cuda(table: BuildTable, probe: Batch,
                    key_names: Tuple[str, ...], build_keys: Tuple[str, ...],
                    verify: str, negate: bool) -> torch.Tensor:
    from presto_tpu_torch.native import cuda
    dev = probe.device
    n = probe.capacity
    nb = table.sorted_hash.shape[0]
    common.check_rows(probe.row_valid, n, dev, (torch.bool,),
                      "semi_join: row_valid")
    mode = _semi_mode(table, verify)
    kd, km, kt, nk, _desc = common.key_group_args(
        [probe.columns[k].astuple() for k in key_names], n, dev,
        "semi_join")
    if mode == _SEMI_WALK_FULL:
        bd, bm, bt, _, _bdesc = common.key_group_args(
            [table.batch.columns[k].astuple() for k in build_keys], nb,
            dev, "semi_join: build keys")
    else:
        bd = bm = bt = None
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    lib = cuda.library("semi_join")
    status = lib.presto_semi_join(
        kd, km, kt, nk, ctypes.c_void_p(probe.row_valid.data_ptr()),
        ctypes.c_int64(n), ctypes.c_void_p(table.sorted_hash.data_ptr()),
        ctypes.c_void_p(table.hash2.data_ptr()),
        ctypes.c_void_p(table.part_starts.data_ptr()),
        ctypes.c_void_p(table.run_len.data_ptr()),
        ctypes.c_int32(table.radix_bits), ctypes.c_int32(mode), bd, bm, bt,
        ctypes.c_int32(int(negate)), ctypes.c_void_p(keep.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "semi_join")
    SEMI_JOIN_KERNEL.launches += 1
    return keep


def semi_mark(table: BuildTable, probe: Batch, key_names: Tuple[str, ...],
              build_keys: Optional[Tuple[str, ...]] = None,
              verify: str = "hash", negate: bool = False) -> torch.Tensor:
    """K7: the keep mask of a semi join (see `semi_mark_plain`). The
    CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    _tk.count("semi_join")
    if verify not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {verify!r}")
    build_keys = tuple(build_keys or key_names)
    if len(build_keys) != len(key_names):
        raise ValueError("semi join: probe and build key lists differ "
                         "in length")
    if probe.device.type == "cpu":
        return semi_mark_plain(table, probe, key_names, build_keys, verify,
                               negate)
    return _semi_mark_cuda(table, probe, key_names, build_keys, verify,
                           negate)


# -- K9: the expansion ---------------------------------------------------


def probe_join(table: BuildTable, probe: Batch,
               key_names: Tuple[str, ...], out_capacity: int,
               join_type: str, probe_output: Tuple[str, ...],
               build_output: Tuple[str, ...],
               build_keys: Tuple[str, ...], verify: str = "hash"
               ) -> Tuple[Batch, torch.Tensor, torch.Tensor]:
    """Probe with no host sync; the output capacity is the caller's
    (probe capacity x an expansion factor). Returns (output batch,
    overflow flag, live output rows), all on the device: the operator
    accumulates the flag and the runner reads it once per query (the
    aligned layout cannot overflow)."""
    _tk.count("join_probe")
    if join_type not in ("inner", "left"):
        raise ValueError(f"probe_join: join type {join_type!r} (a full "
                         "join probes through probe_join_full)")
    lo_enc, h2 = probe_search(table, probe, key_names, verify)
    return _expand_from_enc(table, probe, key_names, lo_enc,
                            out_capacity, join_type, probe_output,
                            build_output, build_keys, verify, h2)


def probe_join_full(table: BuildTable, probe: Batch,
                    key_names: Tuple[str, ...], matched: torch.Tensor,
                    out_capacity: int, probe_output: Tuple[str, ...],
                    build_output: Tuple[str, ...],
                    build_keys: Tuple[str, ...], verify: str = "hash"
                    ) -> Tuple[Batch, torch.Tensor, torch.Tensor]:
    """FULL OUTER probe step: what a left-join probe emits (an unmatched
    probe row keeps one NULL-build row), plus this batch's verified
    matches folded into the running per-build-row `matched` flags, with
    no host sync (reference: presto_tpu/ops/join.py:506). The port
    updates `matched` (bool, one flag per build row) in place, where the
    reference returns a new array: every writer stores True, and the
    operator keeps one tensor for the whole probe. Returns (output
    batch, overflow flag, live output rows)."""
    _tk.count("join_probe")
    common.check_rows(matched, table.sorted_hash.shape[0], probe.device,
                      (torch.bool,), "probe_join_full: matched")
    lo_enc, h2 = probe_search(table, probe, key_names, verify)
    return _expand_from_enc(table, probe, key_names, lo_enc,
                            out_capacity, "full", probe_output,
                            build_output, build_keys, verify, h2, matched)


def _expand_from_enc(table, probe, key_names, lo_enc, out_capacity,
                     join_type, probe_output, build_output, build_keys,
                     verify, h2, matched=None):
    """K9: pick the aligned or general layout and expand; returns
    (output batch, overflow flag, live output rows), all on the device.
    A full join (`matched` given) also sets matched[brow] for every
    verified slot. The CUDA kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if (join_type == "full") != (matched is not None):
        raise ValueError("join_expand: the matched flags go with, and "
                         "only with, a full join")
    if lo_enc.device.type != "cpu":
        return _expand_cuda(table, probe, key_names, lo_enc, out_capacity,
                            join_type, probe_output, build_output,
                            build_keys, verify, h2, matched)
    return expand_plain(table, probe, key_names, lo_enc, out_capacity,
                        join_type, probe_output, build_output, build_keys,
                        verify, h2, matched)


def _aligned_layout(table: BuildTable, probe: Batch, out_capacity: int,
                    join_type: str) -> bool:
    return table.unique_runs and join_type in JOIN_TYPES \
        and out_capacity == probe.capacity


#: launches of the CUDA join-expand kernel (csrc/join_expand.cu)
JOIN_EXPAND_KERNEL = _tk.LaunchCounter("join_expand", "join_probe")
#: probe rows of an aligned or count-pass K9 block (TILE), and rows and
#: slots together of a write block (NV), in csrc/join_expand.cu
EXPAND_TILE = 1024
EXPAND_ITEMS = 1024
#: most probe rows, and most output slots, K9 takes: its offsets and
#: counts are 32-bit
EXPAND_MAX_ROWS = (1 << 31) - 1
#: K9's general-layout scratch per (device, stream): int64 words, as
#: many as the largest call so far needed (`expand_scratch_words`)
_EXPAND_SCRATCH: dict = {}


def expand_scratch_words(n: int, out_cap: int) -> int:
    """Int64 words of K9's general scratch: each probe row's first slot,
    the write blocks' first rows, each row's unmatched flag (a byte)."""
    return n + -(-(n + out_cap) // EXPAND_ITEMS) + 1 + -(-n // 8)


def _expand_scratch(dev, stream: int, words: int) -> torch.Tensor:
    hit = _EXPAND_SCRATCH.get((dev, stream))
    if hit is None or hit.shape[0] < words:
        hit = torch.empty(words, dtype=torch.int64, device=dev)
        _EXPAND_SCRATCH[(dev, stream)] = hit
    return hit


def _column_arrays(c: Column, rows: int, dev, what: str):
    """A column's data and mask as K9 reads them (contiguous), checked
    once."""
    d, m = c.data.contiguous(), c.mask.contiguous()
    if d.device != dev or m.device != dev or d.dim() != 1 \
            or d.shape[0] != rows or m.shape[0] != rows \
            or m.dtype != torch.bool:
        raise ValueError(
            f"join_expand: column {what} must be 1-D data and a bool mask "
            f"of {rows} rows on {dev}; got {d.dtype} {tuple(d.shape)} / "
            f"{m.dtype} {tuple(m.shape)} on {d.device}")
    return d, m


def _r16(x: int) -> int:
    return (x + 15) & ~15


def _expand_cuda(table, probe, key_names, lo_enc, out_capacity, join_type,
                 probe_output, build_output, build_keys, verify, h2,
                 matched=None):
    from presto_tpu_torch.native import cuda
    if verify not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {verify!r}")
    dev = probe.device
    n = probe.capacity
    nb = table.sorted_hash.shape[0]
    aligned = _aligned_layout(table, probe, out_capacity, join_type)
    cap = n if aligned else int(out_capacity)
    if max(n, cap) > EXPAND_MAX_ROWS:
        raise ValueError(f"join_expand: {n} probe rows into {cap} slots; "
                         f"its counts hold at most {EXPAND_MAX_ROWS}")
    # run_len and hash2 were checked once, by BuildTable
    common.check_rows(lo_enc, n, dev, (torch.int64,), "join_expand: lo_enc")
    common.check_rows(probe.row_valid, n, dev, (torch.bool,),
                      "join_expand: row_valid")
    if h2 is not None:
        common.check_rows(h2, n, dev, (torch.int64,), "join_expand: h2")
    if matched is not None:
        common.check_rows(matched, nb, dev, (torch.bool,),
                          "join_expand: matched")
    full = verify == "full"
    if full:
        pk = common.key_group_args(
            [probe.columns[k].astuple() for k in key_names], n, dev,
            "join_expand: probe keys")
        bk = common.key_group_args(
            [table.batch.columns[k].astuple() for k in build_keys], nb,
            dev, "join_expand: build keys")
    else:
        pk = bk = (None, None, None, 0, None)
    # the outputs are views of one allocation: each column's data (an
    # aligned probe column's passes through), each mask, the liveness,
    # then the four stats words
    outs, off = [], 0
    for side, names, batch, rows in ((0, probe_output, probe, n),
                                     (1, build_output, table.batch, nb)):
        for name in names:
            c = batch.columns[name]
            d, m = _column_arrays(c, rows, dev, name)
            w = d.element_size()
            own = not (aligned and side == 0)
            outs.append((name, c, d, m, side, w, off if own else None))
            off += _r16(cap * w) if own else 0
    mask_at = off
    live_at = mask_at + len(outs) * _r16(cap)
    stats_at = live_at + _r16(cap)
    buf = torch.empty(stats_at + 32, dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    cols: Dict[str, Column] = {}
    src, src_mask, dst, dst_mask, sizes, sides = (
        array.array("q"), array.array("q"), array.array("q"),
        array.array("q"), array.array("i"), array.array("i"))
    for i, (name, c, d, m, side, w, doff) in enumerate(outs):
        moff = mask_at + i * _r16(cap)
        data = d if doff is None else buf[doff:doff + cap * w].view(d.dtype)
        cols[name] = Column(data, buf[moff:moff + cap].view(torch.bool),
                            c.type, c.dictionary)
        src.append(d.data_ptr())
        src_mask.append(m.data_ptr())
        dst.append(0 if doff is None else base + doff)
        dst_mask.append(base + moff)
        sizes.append(w)
        sides.append(side)
    live = buf[live_at:live_at + cap].view(torch.bool)
    stats = buf[stats_at:stats_at + 32].view(torch.int64)
    # the overflow flag: stats[1]'s low byte (0 or 1), read in place
    overflow = buf[stats_at + 8:stats_at + 9].view(torch.bool)[0]
    lib = cuda.library("join_expand")
    stream = cuda.stream_ptr(dev)
    args = (int(aligned), lo_enc.data_ptr(), probe.row_valid.data_ptr(), n,
            table.run_len.data_ptr(), table.hash2.data_ptr(),
            None if h2 is None else h2.data_ptr(), nb,
            int(join_type in ("left", "full")), int(full), pk[0], pk[1],
            pk[2], bk[0], bk[1], bk[2], pk[3])
    # more than GATHER_MAX_COLS output columns take several launches;
    # each recomputes the same slots, liveness, stats and matched flags
    ncols = len(outs)
    for lo in range(0, max(ncols, 1), common.GATHER_MAX_COLS):
        hi = min(lo + common.GATHER_MAX_COLS, ncols)
        at = lambda a, size: a.buffer_info()[0] + lo * size
        table_args = (at(src, 8), at(src_mask, 8), at(dst, 8),
                      at(dst_mask, 8), at(sizes, 4), at(sides, 4), hi - lo)
        if aligned:
            stats.zero_()
            status = lib.presto_join_expand(
                *args, *table_args, live.data_ptr(), cap, stats.data_ptr(),
                None, None, None, 0,
                None if matched is None else matched.data_ptr(), stream)
        else:
            with common.LOOKBACK_LOCK:
                scratch = _expand_scratch(dev, stream,
                                          expand_scratch_words(n, cap))
                ticket, status_words, epoch = common.lookback_scratch(
                    dev, stream, -(-n // EXPAND_TILE))
                status = lib.presto_join_expand(
                    *args, *table_args, live.data_ptr(), cap,
                    stats.data_ptr(), scratch.data_ptr(), ticket.data_ptr(),
                    status_words.data_ptr(), epoch,
                    None if matched is None else matched.data_ptr(), stream)
        cuda.check(lib, status, "join_expand")
        JOIN_EXPAND_KERNEL.launches += 1
    return Batch(cols, live), overflow, stats[0 if aligned else 2]


def expand_plain(table, probe, key_names, lo_enc, out_capacity,
                 join_type, probe_output, build_output, build_keys,
                 verify, h2, matched=None):
    """Plain version of K9 (the reference's `_expand_aligned` /
    `_expand_general` after the search, and `_expand_from_enc`'s
    matched-flag fold for a full join, here in place)."""
    if _aligned_layout(table, probe, out_capacity, join_type):
        out, overflow, brow, verified = _expand_aligned(
            table, probe, key_names, lo_enc, join_type, probe_output,
            build_output, build_keys, verify)
    else:
        found = lo_enc >= 0
        lo = torch.clamp(lo_enc, min=0)
        counts = torch.where(found, table.run_len[lo],
                             torch.zeros_like(lo))
        out, overflow, brow, verified = _expand_general(
            table, probe, key_names, lo, counts, out_capacity, join_type,
            probe_output, build_output, build_keys, verify, h2)
    if matched is not None:
        matched[brow[verified]] = True
    return out, overflow, out.row_valid.sum()


def _expand_aligned(table, probe, key_names, lo_enc, join_type,
                    probe_output, build_output, build_keys, verify):
    """Output slot i is probe row i (unique-run build, capacity match).
    An inner miss is a dead slot; a left or full miss keeps the probe
    side with a NULL build side. Never overflows. Returns (batch,
    overflow, candidate build row, verified) per slot."""
    verified = lo_enc >= 0
    brow = torch.clamp(lo_enc, min=0)
    if verify == "full":
        # one candidate per row: compare the actual key columns
        for kn, bn in zip(key_names, build_keys):
            pd, pm = probe.columns[kn].astuple()
            bd, bm = table.batch.columns[bn].astuple()
            verified = verified & (pd == bd[brow]) & pm & bm[brow]
    live = probe.row_valid if join_type in ("left", "full") else verified
    cols: Dict[str, Column] = {}
    for name in probe_output:
        c = probe.columns[name]
        cols[name] = Column(c.data, c.mask & live, c.type, c.dictionary)
    for name in build_output:
        c = table.batch.columns[name]
        cols[name] = Column(c.data[brow], c.mask[brow] & verified,
                            c.type, c.dictionary)
    return Batch(cols, live), torch.zeros((), dtype=torch.bool,
                                          device=probe.device), \
        brow, verified


def _expand_general(table, probe, key_names, lo, counts, out_capacity,
                    join_type, probe_output, build_output, build_keys,
                    verify, h2):
    """Prefix-sum expansion for duplicate-key builds: output slot j
    belongs to probe row p(j), candidate build slot lo[p] + (j -
    cum[p]); p(j) comes from expand-by-counts (a 1 at each probe row's
    first slot, prefix-summed). Returns (batch, overflow, candidate
    build row, verified) per slot."""
    if verify not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {verify!r}")
    dev = probe.device
    left_join = join_type in ("left", "full")
    emit = counts
    if left_join:
        emit = torch.where(probe.row_valid & (counts == 0),
                           torch.ones_like(counts), counts)
        emit = torch.where(probe.row_valid, emit, torch.zeros_like(emit))
    cum = torch.cumsum(emit, 0) - emit  # exclusive prefix
    total = cum[-1] + emit[-1]
    nprobe = emit.shape[0]
    slots = torch.arange(out_capacity, device=dev)
    heads = torch.zeros(out_capacity + 1, dtype=torch.int64, device=dev)
    heads.index_add_(0, torch.clamp(cum, 0, out_capacity),
                     torch.ones_like(cum))
    pid = torch.clamp(torch.cumsum(heads[:out_capacity], 0) - 1, 0,
                      nprobe - 1)
    k = slots - cum[pid]
    slot_live = slots < total
    is_match = slot_live & (k < counts[pid])
    brow = torch.clamp(lo[pid] + k, 0, table.sorted_hash.shape[0] - 1)
    if verify == "hash":
        # h2 is None when the search already held hash2 to the build's
        verified = is_match if h2 is None \
            else is_match & (h2[pid] == table.hash2[brow])
    else:
        verified = is_match
        for kn, bn in zip(key_names, build_keys):
            pd, pm = probe.columns[kn].astuple()
            bd, bm = table.batch.columns[bn].astuple()
            verified = verified & (pd[pid] == bd[brow]) & pm[pid] \
                & bm[brow]
    if left_join:
        # a probe row with no verified match (collisions included)
        # emits one NULL-build row in its first slot
        nver = torch.zeros(nprobe, dtype=torch.int64, device=dev)
        nver.index_add_(0, pid, verified.to(torch.int64))
        unmatched = slot_live & (k == 0) & (nver[pid] == 0) \
            & probe.row_valid[pid]
        live = verified | unmatched
    else:
        live = verified
    cols: Dict[str, Column] = {}
    for name in probe_output:
        c = probe.columns[name]
        cols[name] = Column(c.data[pid], c.mask[pid] & live, c.type,
                            c.dictionary)
    for name in build_output:
        c = table.batch.columns[name]
        cols[name] = Column(c.data[brow], c.mask[brow] & verified, c.type,
                            c.dictionary)
    return Batch(cols, live), total > out_capacity, brow, verified


# -- K11: the FULL join's outer tail ----------------------------------------


#: launches of the CUDA outer-tail kernel (csrc/join_outer.cu)
JOIN_OUTER_KERNEL = _tk.LaunchCounter("join_outer", "join_outer")


def unmatched_build_plain(table: BuildTable, matched: torch.Tensor,
                          probe_schema: Tuple[Tuple, ...],
                          build_output: Tuple[str, ...]):
    """Plain version of K11 (the reference's `unmatched_build`): the
    build rows no probe row matched (live = row_valid & ~matched), the
    probe side all-NULL. Returns (batch, live count)."""
    live = table.batch.row_valid & ~matched
    n = matched.shape[0]
    dev = matched.device
    cols: Dict[str, Column] = {}
    for name, typ, dic in probe_schema:
        cols[name] = Column(torch.zeros(n, dtype=typ.torch_dtype,
                                        device=dev),
                            torch.zeros(n, dtype=torch.bool, device=dev),
                            typ, dic)
    for name in build_output:
        c = table.batch.columns[name]
        cols[name] = Column(c.data, c.mask & live, c.type, c.dictionary)
    return Batch(cols, live), live.sum()


def _unmatched_build_cuda(table: BuildTable, matched: torch.Tensor,
                          probe_schema: Tuple[Tuple, ...],
                          build_output: Tuple[str, ...]):
    from presto_tpu_torch.native import cuda
    build = table.batch
    dev = build.device
    n = build.capacity
    common.check_rows(build.row_valid, n, dev, (torch.bool,),
                      "join_outer: row_valid")
    common.check_rows(matched, n, dev, (torch.bool,), "join_outer: matched")
    cols: Dict[str, Column] = {}
    # per column: (src data, src mask, dst data, dst mask, size, side);
    # a probe column is written (zero, NULL), a build column's mask is
    # ANDed with the liveness and its data passes through
    spec = []
    for name, typ, dic in probe_schema:
        data = torch.empty(n, dtype=typ.torch_dtype, device=dev)
        mask = torch.empty(n, dtype=torch.bool, device=dev)
        cols[name] = Column(data, mask, typ, dic)
        spec.append((0, 0, data.data_ptr(), mask.data_ptr(),
                       data.element_size(), 0))
    for name in build_output:
        c = build.columns[name]
        common.check_rows(c.mask, n, dev, (torch.bool,),
                          f"join_outer: mask of {name}")
        mask = torch.empty(n, dtype=torch.bool, device=dev)
        cols[name] = Column(c.data, mask, c.type, c.dictionary)
        spec.append((0, c.mask.data_ptr(), 0, mask.data_ptr(), 8, 1))
    live = torch.empty(n, dtype=torch.bool, device=dev)
    count = torch.empty(1, dtype=torch.int64, device=dev)
    lib = cuda.library("join_outer")
    for table_args in common.gather_chunks(spec, "join_outer"):
        count.zero_()
        status = lib.presto_join_outer(
            ctypes.c_void_p(build.row_valid.data_ptr()),
            ctypes.c_void_p(matched.data_ptr()), ctypes.c_int64(n),
            *table_args, ctypes.c_void_p(live.data_ptr()),
            ctypes.c_void_p(count.data_ptr()),
            ctypes.c_void_p(cuda.stream_ptr(dev)))
        cuda.check(lib, status, "join_outer")
        JOIN_OUTER_KERNEL.launches += 1
    return Batch(cols, live), count[0]


def unmatched_build(table: BuildTable, matched: torch.Tensor,
                    probe_schema: Tuple[Tuple, ...],
                    build_output: Tuple[str, ...]):
    """K11: the FULL join's final batch, the build rows no probe row
    ever matched with the probe side all-NULL (reference:
    presto_tpu/ops/join.py:689; LookupOuterOperator's appendTo loop).
    `probe_schema` is ((name, type, dictionary), ...) for the NULL probe
    columns. Returns (batch, live count), both on the device. The CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _tk.count("join_outer")
    if matched.device.type == "cpu":
        return unmatched_build_plain(table, matched, probe_schema,
                                     build_output)
    return _unmatched_build_cuda(table, matched, probe_schema, build_output)
