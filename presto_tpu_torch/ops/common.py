"""Shared kernel utilities (reference: presto_tpu/ops/common.py):
null-aware multi-key ordering, group boundaries, the bounded search and
the row hashes.

The row hashes (`hash64`, `hash64b`, `row_hash`, `row_hash2`) equal the
reference's bit for bit. The reference mixes in uint64 so its
xor-shifts are logical; torch on the CPU has no uint64 `>>`, so the
plain versions here compute in int64 and mask the sign extension off
every right shift (`_lshr`). Multiplication wraps identically in both.

`row_hash_pair` is kernel K3 (csrc/row_hash.cu) on CUDA tensors and
`row_hash_pair_plain` on CPU tensors: both hashes of a row in one pass,
with the invalid-row sentinels folded in. The join probe (K5) computes
the same hashes with the same device code (csrc/row_hash.cuh), so a
probe row always finds its build row.
"""

from __future__ import annotations

import array
import ctypes
import functools
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch.telemetry import kernels as _tk

CVal = Tuple[torch.Tensor, torch.Tensor]

#: int64 sentinel hash of a dead row (NULL join key or row_valid False):
#: it sorts to the end of a hash-sorted build
H_INVALID = torch.iinfo(torch.int64).max
#: second-hash sentinel of such a row
H2_INVALID = torch.iinfo(torch.int64).min


def _s64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_NULL_LANE = -0x61C8864680B583EB
_NULL_LANE_B = 0x2545F4914F6CDD1D
_SPLITMIX = (_s64(0xBF58476D1CE4E5B9), _s64(0x94D049BB133111EB))
_FMIX = (_s64(0xFF51AFD7ED558CCD), _s64(0xC4CEB9FE1A85EC53))


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (uint64 `>>`)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _key_bits(data: torch.Tensor) -> torch.Tensor:
    """The int64 the hashes mix: floats widened to float64 and
    bitcast, everything else widened to int64."""
    if data.dtype in (torch.float32, torch.float64):
        return data.to(torch.float64).view(torch.int64)
    return data.to(torch.int64)


def hash64(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Splitmix64 avalanche hash; a NULL lane hashes a fixed value."""
    x = torch.where(mask, _key_bits(data),
                    torch.full_like(mask, _NULL_LANE, dtype=torch.int64))
    x = (x ^ _lshr(x, 30)) * _SPLITMIX[0]
    x = (x ^ _lshr(x, 27)) * _SPLITMIX[1]
    return x ^ _lshr(x, 31)


def hash64b(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The second, independent avalanche hash (murmur3 fmix64) with its
    own NULL lane."""
    x = torch.where(mask, _key_bits(data),
                    torch.full_like(mask, _NULL_LANE_B, dtype=torch.int64))
    x = (x ^ _lshr(x, 33)) * _FMIX[0]
    x = (x ^ _lshr(x, 33)) * _FMIX[1]
    return x ^ _lshr(x, 33)


def row_hash(cols: Sequence[CVal]) -> torch.Tensor:
    """Combined hash of several key columns (h * 31 + next)."""
    h = None
    for data, mask in cols:
        hi = hash64(data, mask)
        h = hi if h is None else h * 31 + hi
    if h is None:
        raise ValueError("row_hash of no columns")
    return h


def row_hash2(cols: Sequence[CVal]) -> torch.Tensor:
    """Combined second hash (h * 37 + next): with row_hash, a 128-bit
    fingerprint of the key."""
    h = None
    for data, mask in cols:
        hi = hash64b(data, mask)
        h = hi if h is None else h * 37 + hi
    if h is None:
        raise ValueError("row_hash2 of no columns")
    return h


def row_hash_pair_plain(keys: Sequence[CVal], row_valid: torch.Tensor,
                        nulls_invalid: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: (h, h2) per row. A row is dead when
    row_valid is False or, with `nulls_invalid` (the join's rule), when
    any key is NULL. A dead row's h is H_INVALID; with `nulls_invalid`
    its h2 is H2_INVALID too (the reference's `_hash_batch` and
    `_probe_hashes`), else it keeps row_hash2 (the reference's
    `_group_reduce`, where a NULL key is a group of its own)."""
    live = row_valid
    if nulls_invalid:
        for _, m in keys:
            live = live & m
    h = torch.where(live, row_hash(keys),
                    torch.full_like(live, H_INVALID, dtype=torch.int64))
    h2 = row_hash2(keys)
    if nulls_invalid:
        h2 = torch.where(live, h2, torch.full_like(h2, H2_INVALID))
    return h, h2


#: launches of the CUDA row-hash kernel (csrc/row_hash.cu)
ROW_HASH_KERNEL = _tk.LaunchCounter("row_hash")

#: key dtype -> code of csrc/row_hash.cuh `KeyDtype`
KEY_DTYPES = {torch.bool: 0, torch.int8: 0, torch.int16: 1,
              torch.int32: 2, torch.int64: 3, torch.float32: 4,
              torch.float64: 5}
#: most key columns of one KeyCols group (PRESTO_MAX_KEYS)
MAX_KEYS = 8
#: key groups a K5, K7, K8 or K9 launch takes in its arguments
#: (PRESTO_MAX_KEY_GROUPS); the groups past them go to the kernel as a
#: descriptor in device memory (`key_group_args`)
MAX_KEY_GROUPS = 3
#: most output columns one gathering kernel takes (csrc/gather.cuh
#: PRESTO_MAX_COLS), and the element sizes it copies
GATHER_MAX_COLS = 64
GATHER_ELEM_SIZES = (1, 2, 4, 8)


def gather_table(spec: Sequence[Tuple[int, int, int, int, int, int]],
                 what: str):
    """The ctypes host arrays of csrc/gather.cuh's `Cols`, from one
    (src data, src mask, dst data, dst mask address, element size,
    side) tuple per output column: four int64 address arrays, the sizes
    and sides as int32 arrays, and the column count."""
    if len(spec) > GATHER_MAX_COLS:
        raise ValueError(f"{what}: at most {GATHER_MAX_COLS} output "
                         f"columns, got {len(spec)}")
    for i, col in enumerate(spec):
        if col[4] not in GATHER_ELEM_SIZES:
            raise ValueError(f"{what}: output column {i} has "
                             f"{col[4]}-byte elements")
    n = max(len(spec), 1)
    fields = list(zip(*spec)) if spec else [()] * 6
    P, I = ctypes.c_int64 * n, ctypes.c_int32 * n
    return (*(P(*f) for f in fields[:4]), *(I(*f) for f in fields[4:]),
            ctypes.c_int32(len(spec)))


def gather_chunks(spec: Sequence[Tuple[int, int, int, int, int, int]],
                  what: str):
    """`gather_table`'s arguments for each run of at most
    GATHER_MAX_COLS output columns (one run when there are none): a
    gathering kernel takes more columns over several launches."""
    runs = [spec[lo:lo + GATHER_MAX_COLS]
            for lo in range(0, len(spec), GATHER_MAX_COLS)] or [spec]
    return [gather_table(run, what) for run in runs]


def _check_keys(keys: Sequence[CVal], n: int, dev: torch.device,
                what: str) -> None:
    """Raise unless every key column is a contiguous 1-D tensor of `n`
    rows on `dev`, of a KEY_DTYPES dtype with a bool mask."""
    for d, m in keys:
        for t, dts in ((d, KEY_DTYPES), (m, (torch.bool,))):
            if t.device != dev or t.dim() != 1 or t.shape[0] != n \
                    or not t.is_contiguous() or t.dtype not in dts:
                raise ValueError(
                    f"{what}: key columns must be contiguous 1-D "
                    f"tensors of {n} rows on {dev} (data of "
                    f"{sorted(str(x) for x in KEY_DTYPES)}, bool "
                    f"masks); got {t.dtype} {tuple(t.shape)} stride "
                    f"{t.stride()} on {t.device}")


@functools.lru_cache(maxsize=256)
def _dtype_codes(dtypes: Tuple[torch.dtype, ...], width: int):
    """The KEY_DTYPES codes of `dtypes` as a ctypes int32 array of
    `width` entries (zeros past them), built once per signature: the
    kernels only read it, and a probe's key dtypes repeat every batch."""
    return (ctypes.c_int32 * width)(*[KEY_DTYPES[d] for d in dtypes])


def key_args(keys: Sequence[CVal], n: int, dev: torch.device,
             what: str):
    """Check key columns for a CUDA kernel that hashes them and build
    the ctypes host arrays (data pointers, mask pointers, dtype codes)
    of csrc/row_hash.cuh's `KeyCols`. The dtype codes are shared by
    every call with the same key dtypes."""
    if not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"{what}: 1 to {MAX_KEYS} key columns, got "
                         f"{len(keys)}")
    _check_keys(keys, n, dev, what)
    P = ctypes.c_int64 * MAX_KEYS
    return (P(*[d.data_ptr() for d, _ in keys]),
            P(*[m.data_ptr() for _, m in keys]),
            _dtype_codes(tuple(d.dtype for d, _ in keys), MAX_KEYS),
            ctypes.c_int32(len(keys)))


def key_groups(keys: Sequence[CVal]) -> List[Sequence[CVal]]:
    """Successive runs of at most MAX_KEYS key columns, in key order."""
    return [keys[lo:lo + MAX_KEYS] for lo in range(0, len(keys), MAX_KEYS)]


def key_group_args(keys: Sequence[CVal], n: int, dev: torch.device,
                   what: str):
    """`key_args` for a kernel that compares groups of key columns in
    turn (csrc/row_hash.cuh `KeyGroups`): every column is checked as
    `key_args` checks it, and the tables are passed flat, group after
    group, with the total key count (the dtype codes shared per
    signature, as `key_args` shares them). Past MAX_KEY_GROUPS groups
    the later groups also go to the device as a descriptor of one
    KeyCols (21 int64 words) each, whose address follows the last key's
    in the data table. Returns (data, masks, dtypes, count, the
    descriptor tensor or None): the caller holds the last until its
    launch is queued."""
    if not keys:
        raise ValueError(f"{what}: no key columns")
    _check_keys(keys, n, dev, what)
    nk = len(keys)
    data = [d.data_ptr() for d, _ in keys]
    masks = [m.data_ptr() for _, m in keys]
    dtypes = tuple(d.dtype for d, _ in keys)
    desc = None
    if nk > MAX_KEY_GROUPS * MAX_KEYS:
        rows = np.zeros((-(-nk // MAX_KEYS) - MAX_KEY_GROUPS, 21),
                        dtype=np.int64)
        for r, lo in enumerate(range(MAX_KEY_GROUPS * MAX_KEYS, nk,
                                     MAX_KEYS)):
            hi = min(lo + MAX_KEYS, nk)
            rows[r, 0:hi - lo] = data[lo:hi]
            rows[r, 8:8 + hi - lo] = masks[lo:hi]
            rows[r, 16:20] = np.frombuffer(
                _dtype_codes(dtypes[lo:hi], MAX_KEYS), dtype=np.int64)
            rows[r, 20] = hi - lo
        desc = torch.from_numpy(rows)
        if dev.type == "cuda":
            desc = desc.pin_memory().to(dev, non_blocking=True)
        data.append(desc.data_ptr())
    return ((ctypes.c_int64 * len(data))(*data),
            (ctypes.c_int64 * nk)(*masks), _dtype_codes(dtypes, nk),
            ctypes.c_int32(nk), desc)


def check_rows(t: torch.Tensor, n: int, dev: torch.device, dtypes,
               what: str) -> None:
    """Raise unless `t` is a contiguous 1-D tensor of `n` rows of one
    of `dtypes` on `dev` (the CUDA wrappers' input check)."""
    if t.device != dev or t.dim() != 1 or t.shape[0] != n \
            or not t.is_contiguous() or t.dtype not in dtypes:
        raise ValueError(
            f"{what} must be a contiguous 1-D "
            f"{'/'.join(str(d) for d in dtypes)} tensor of {n} rows on "
            f"{dev}; got {t.dtype} {tuple(t.shape)} stride {t.stride()} "
            f"on {t.device}")


#: launches of K3 that hashed the rows of more than one source (a
#: merge's partial states, hashagg_merge), counted beside ROW_HASH_KERNEL
ROW_HASH_SOURCES_KERNEL = _tk.LaunchCounter("row_hash_sources",
                                            "hashagg_merge")
#: most sources one K3 or K26 launch reads (csrc/row_hash.cu,
#: csrc/gather_rows.cu MAX_SOURCES)
MAX_SOURCES = 8


def _row_hash_cuda(parts: Sequence[Tuple[Sequence[CVal], torch.Tensor]],
                   nulls_invalid: bool):
    """K3 over one or more sources; more than MAX_KEYS keys are hashed
    MAX_KEYS at a time and chained: row_hash is linear in its parts (h
    = h_a * 31^m + h_b, m the keys of the later part, wrapping like the
    reference's uint64 arithmetic), and likewise row_hash2 with 37, so
    the chained result equals the reference's bit for bit; the dead-row
    sentinels are folded in at the end."""
    nkeys = len(parts[0][0])
    if nkeys <= MAX_KEYS:
        return _row_hash_launch(parts, nulls_invalid)
    every = [(keys, torch.ones_like(valid)) for keys, valid in parts]
    h = h2 = None
    for lo in range(0, nkeys, MAX_KEYS):
        sub = [(keys[lo:lo + MAX_KEYS], valid) for keys, valid in every]
        width = len(sub[0][0])
        ph, ph2 = _row_hash_launch(sub, False)
        if h is None:
            h, h2 = ph, ph2
        else:
            h = h * _s64(31 ** width) + ph
            h2 = h2 * _s64(37 ** width) + ph2
    lo = 0
    for keys, valid in parts:
        live = valid
        if nulls_invalid:
            for _, m in keys:
                live = live & m
        rows = slice(lo, lo + valid.shape[0])
        h[rows] = torch.where(live, h[rows], H_INVALID)
        if nulls_invalid:
            h2[rows] = torch.where(live, h2[rows], H2_INVALID)
        lo += valid.shape[0]
    return h, h2


def _cat_parts(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    return ts[0] if len(ts) == 1 else torch.cat(list(ts))


def _row_hash_launch(parts, nulls_invalid: bool):
    from presto_tpu_torch.native import cuda
    if not 1 <= len(parts) <= MAX_SOURCES:
        raise ValueError(f"row_hash: 1 to {MAX_SOURCES} sources, got "
                         f"{len(parts)}")
    dev = parts[0][1].device
    tables, offs = [], [0]
    for keys, valid in parts:
        n = valid.shape[0]
        check_rows(valid, n, dev, (torch.bool,), "row_hash: row_valid")
        tables.append(key_args(keys, n, dev, "row_hash"))
        offs.append(offs[-1] + n)
    dtypes = [t[2][:t[3].value] for t in tables]
    if any(d != dtypes[0] for d in dtypes):
        raise ValueError("row_hash: the sources' key dtypes differ")
    nk = tables[0][3].value
    total = offs[-1]
    h = torch.empty(total, dtype=torch.int64, device=dev)
    h2 = torch.empty(total, dtype=torch.int64, device=dev)
    lib = cuda.library("row_hash")
    flat = [[t[f][j] for t in tables for j in range(nk)] for f in range(2)]
    status = lib.presto_row_hash(
        _ptrs_raw(flat[0]), _ptrs_raw(flat[1]), tables[0][2],
        ctypes.c_int32(nk), ctypes.c_int32(len(parts)),
        _ptrs([v for _, v in parts]), _ptrs_raw(offs),
        ctypes.c_int32(int(nulls_invalid)),
        ctypes.c_void_p(h.data_ptr()), ctypes.c_void_p(h2.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "row_hash")
    ROW_HASH_KERNEL.launches += 1
    if len(parts) > 1:
        ROW_HASH_SOURCES_KERNEL.launches += 1
    return h, h2


def row_hash_pair(keys: Sequence[CVal], row_valid: torch.Tensor,
                  nulls_invalid: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: both row hashes of every row, dead rows folded to their
    sentinels (see `row_hash_pair_plain`). The CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    return row_hash_sources([(keys, row_valid)], nulls_invalid)


def row_hash_sources(parts: Sequence[Tuple[Sequence[CVal], torch.Tensor]],
                     nulls_invalid: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 over the rows of up to MAX_SOURCES sources, each (keys,
    row_valid) with the same key dtypes: the hashes of their
    concatenation, with nothing concatenated on the card. On CPU tensors
    the plain version over the concatenation."""
    if parts[0][1].device.type == "cpu":
        return row_hash_sources_plain(parts, nulls_invalid)
    return _row_hash_cuda(parts, nulls_invalid)


def row_hash_sources_plain(parts, nulls_invalid: bool):
    """Plain version of K3 over several sources: `row_hash_pair_plain`
    of their concatenation."""
    nkeys = len(parts[0][0])
    keys = [(_cat_parts([k[j][0] for k, _ in parts]),
             _cat_parts([k[j][1] for k, _ in parts])) for j in range(nkeys)]
    return row_hash_pair_plain(keys, _cat_parts([v for _, v in parts]),
                               nulls_invalid)


def bounded_searchsorted(a: torch.Tensor, v: torch.Tensor,
                         lo: torch.Tensor, hi: torch.Tensor,
                         iters: int, side: str = "left") -> torch.Tensor:
    """Vectorized binary search with per-query bounds [lo, hi):
    `iters` levels of gather + compare (it must cover the largest
    span, see `search_iters`)."""
    n = a.shape[0]
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        mv = a[torch.clamp(mid, 0, max(n - 1, 0))]
        go_left = (mv >= v) if side == "left" else (mv > v)
        hi = torch.where(active & go_left, mid, hi)
        lo = torch.where(active & ~go_left, mid + 1, lo)
    return lo


def search_iters(max_span: int) -> int:
    """Levels bounded_searchsorted needs over spans of at most
    `max_span` rows."""
    import math
    return int(math.ceil(math.log2(max(int(max_span), 2)))) + 1


def lex_perm(sort_ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows by int64 `sort_ops` (most
    significant first; the (h1, h2) hashes of the sort-based grouping).
    On CUDA tensors K25 sorts them as its words, signed; on CPU tensors
    the plain version, `lex_perm_plain`. Keys of other types are
    ordered through `sort_rows`."""
    if any(op.dtype != torch.int64 for op in sort_ops):
        raise ValueError("lex_perm sorts int64 words; got "
                         f"{[str(op.dtype) for op in sort_ops]} (order "
                         "other keys with sort_rows)")
    if sort_ops[0].device.type == "cpu":
        return lex_perm_plain(sort_ops)
    return radix_sort([op.contiguous() for op in sort_ops], flip=True)[0]


def lex_perm_plain(sort_ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """`lex_perm` by stable torch.sort passes, on any device."""
    return _stable_order(sort_ops)


def partition_perm(valid: torch.Tensor) -> torch.Tensor:
    """Stable valid-rows-first permutation (argsort(~valid, stable)),
    built from two cumsums and one scatter."""
    n = valid.shape[0]
    v = valid.to(torch.int64)
    nv = v.sum()
    pos = torch.where(valid, torch.cumsum(v, 0) - 1,
                      nv + torch.cumsum(1 - v, 0) - 1)
    perm = torch.empty(n, dtype=torch.int64, device=valid.device)
    perm[pos] = torch.arange(n, device=valid.device)
    return perm


def _negate_for_desc(key: torch.Tensor) -> torch.Tensor:
    if key.dtype == torch.bool:
        return ~key
    if key.dtype == torch.float32:
        return -key.to(torch.float64)
    return -key


def key_sort_ops(data: torch.Tensor, mask: torch.Tensor, desc: bool,
                 nulls_first: bool) -> List[torch.Tensor]:
    """One key's two sort operands: its null rank (mask under NULLS
    FIRST, ~mask otherwise) and its canonical value: negated under DESC,
    0 for NULL, and for a float key every NaN as one NaN (sorting after
    every number, under ASC and DESC alike) and -0.0 as +0.0. That is
    the order torch.sort gives on the CPU, and the reference's on the
    CPU; it is made explicit so that the card's sort keeps it, and the
    merge of sorted runs (ops/merge.py, K19) compares by it."""
    sv = _negate_for_desc(data) if desc else data
    sv = torch.where(mask, sv, torch.zeros_like(sv))
    if sv.is_floating_point():
        sv = torch.where(torch.isnan(sv), torch.full_like(sv, torch.nan),
                         sv + 0.0)
    return [mask if nulls_first else ~mask, sv]


def _stable_order(sort_ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic permutation over `sort_ops` (most
    significant first): stable passes from the least significant key
    up, as ops/common.lex_order does in the reference."""
    n = sort_ops[0].shape[0]
    perm = torch.arange(n, device=sort_ops[0].device)
    for key in reversed(list(sort_ops)):
        k = key[perm]
        if k.dtype == torch.bool:
            k = k.to(torch.uint8)
        order = torch.sort(k, stable=True).indices
        perm = perm[order]
    return perm


# -- the sort: K24 sort_encode, K25 radix_sort, K26 gather_rows ----------
#
# The reference sorts with one variadic `lax.sort` that carries every
# column (presto_tpu/ops/common.py:100, :232). On the card the same
# result comes from three kernels in a fixed order: K24 turns a row's
# sort operands into unsigned key words whose order is the operands'
# lexicographic order, K25 sorts the words stably and returns the
# permutation, K26 moves every column through it in one launch. On CPU
# tensors each wrapper runs its plain version.

#: launches of the CUDA key-encoding kernel (csrc/sort_encode.cu)
SORT_ENCODE_KERNEL = _tk.LaunchCounter("sort_encode", "sort")
#: launches of the CUDA radix sort (csrc/radix_sort.cu)
RADIX_SORT_KERNEL = _tk.LaunchCounter("radix_sort", "sort")
#: launches of the CUDA row gather (csrc/gather_rows.cu)
GATHER_ROWS_KERNEL = _tk.LaunchCounter("gather_rows", "sort")

#: key dtype -> (code of csrc/sort_code.cuh `SortDtype`, bits of its
#: value code)
SORT_DTYPES = {torch.bool: (0, 1), torch.int8: (1, 8), torch.int16: (2, 16),
               torch.int32: (3, 32), torch.int64: (4, 64),
               torch.float32: (5, 32), torch.float64: (6, 64)}
#: most keys one K24 launch encodes, and most words it writes
#: (csrc/sort_encode.cu MAX_SORT_KEYS, MAX_WORDS); more keys take one
#: launch per run of SORT_MAX_KEYS (`_key_runs`)
SORT_MAX_KEYS = 32
SORT_MAX_WORDS = 64
#: most rows K25 sorts: it carries a 32-bit row index
RADIX_MAX_ROWS = (1 << 31) - 1
#: most arrays (a column's data, its mask) one K26 launch moves
GATHER_MAX_ARRAYS = 64

_I64_MIN = torch.iinfo(torch.int64).min
_I64_MAX = torch.iinfo(torch.int64).max

#: one source of rows for K24 and K26: (columns, row_valid or None), a
#: column being (data, mask or None)
SortPart = Tuple[Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
                 Optional[torch.Tensor]]


def sort_pack_plan(widths: Sequence[int]) -> Tuple[List[int], int]:
    """The bit position of each operand, counted from the most
    significant bit of word 0, with the operands back to back in order
    (one may straddle two words), and the number of 64-bit words."""
    pos, p = [], 0
    for w in widths:
        pos.append(p)
        p += w
    return pos, max(1, -(-p // 64))


def radix_passes(digits: Sequence[int]) -> List[Tuple[int, int]]:
    """K25's passes, least significant first: (word, shift) for each
    8-bit digit, words from the last to the first and digits from the
    low byte up. A digit whose bit is clear in its word's mask of
    varying digits (`digits[w]`, bit d for byte d) is left out: it is
    the same on every row. K25 builds this table on the device from its
    histograms; the card tests and chip_smoke hold it to this one."""
    return [(w, 8 * d) for w in reversed(range(len(digits)))
            for d in range(8) if (digits[w] >> d) & 1]


def _sort_layout(has_valid: bool, keys_meta: Sequence[Tuple[torch.dtype,
                                                             bool]]):
    """(bit position of ~row_valid or -1, per key (position of its null
    rank or -1, position of its value, value bits), words) for keys of
    the given (dtype, has a mask)."""
    widths = [1] if has_valid else []
    for dt, has_mask in keys_meta:
        if dt not in SORT_DTYPES:
            raise ValueError(f"sort_encode: no sort code for a {dt} key "
                             f"(codes exist for "
                             f"{sorted(str(d) for d in SORT_DTYPES)})")
        widths += ([1] if has_mask else []) + [SORT_DTYPES[dt][1]]
    pos, nwords = sort_pack_plan(widths)
    it = iter(pos)
    pos_valid = next(it) if has_valid else -1
    keys = []
    for dt, has_mask in keys_meta:
        rank = next(it) if has_mask else -1
        keys.append((rank, next(it), SORT_DTYPES[dt][1]))
    if nwords > SORT_MAX_WORDS:
        raise ValueError(f"sort_encode: {nwords} key words, at most "
                         f"{SORT_MAX_WORDS}")
    return pos_valid, keys, nwords


def _concat_parts(parts: Sequence[SortPart]):
    """The columns and row_valid of several sources as one (the later
    sources' data cast to the first's dtypes), for the plain versions."""
    cols, valid = parts[0]
    if len(parts) == 1:
        return list(cols), valid
    out = []
    for j, (d, m) in enumerate(cols):
        out.append((torch.cat([d] + [c[j][0].to(d.dtype)
                                     for c, _ in parts[1:]]),
                    None if m is None
                    else torch.cat([c[j][1] for c, _ in parts])))
    return out, None if valid is None else torch.cat([v for _, v in parts])


def _value_code(data: torch.Tensor, mask: Optional[torch.Tensor],
                desc: bool) -> torch.Tensor:
    """The order-preserving unsigned code of a key's canonical value (see
    `key_sort_ops`), as int64 bits: the value negated under DESC with the
    reference's wrap, 0 for NULL, integers with the sign bit flipped in
    their width, floats by the usual transform with every NaN coded
    above +inf and -0.0 as +0.0 (float32 in 32 bits)."""
    sv = _negate_for_desc(data) if desc else data
    if data.dtype == torch.float32:
        sv = sv.to(torch.float32)  # -x is exact in float32
    if mask is not None:
        sv = torch.where(mask, sv, torch.zeros_like(sv))
    if sv.dtype == torch.bool:
        return sv.to(torch.int64)
    if sv.dtype == torch.float32:
        b = sv.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        b = torch.where((b & 0x7FFFFFFF) == 0, torch.zeros_like(b), b)
        code = torch.where((b & 0x80000000) != 0, ~b & 0xFFFFFFFF,
                           b | 0x80000000)
        return torch.where(torch.isnan(sv), torch.full_like(b, 0xFFFFFFFF),
                           code)
    if sv.dtype == torch.float64:
        b = sv.contiguous().view(torch.int64)
        b = torch.where((b & _I64_MAX) == 0, torch.zeros_like(b), b)
        code = torch.where(b < 0, ~b, b ^ _I64_MIN)
        return torch.where(torch.isnan(sv), torch.full_like(b, -1), code)
    bits = SORT_DTYPES[sv.dtype][1]
    if bits == 64:
        return sv ^ _I64_MIN
    return sv.to(torch.int64) + (1 << (bits - 1))


def _place(words: torch.Tensor, code: torch.Tensor, width: int,
           pos: int) -> None:
    """OR a `width`-bit code into the words at bit `pos` (from the most
    significant bit of word 0), split across two words where it
    straddles them (csrc/sort_code.cuh `SortPacker::put`)."""
    w, room = pos >> 6, 64 - (pos & 63)
    if width <= room:
        words[w] |= code << (room - width)
    else:
        words[w] |= _lshr(code, width - room)
        words[w + 1] |= code << (64 - (width - room))


def _vary_digits(words: torch.Tensor) -> torch.Tensor:
    """Per word, an 8-bit mask of the bytes that are not the same on
    every row."""
    if words.shape[1] == 0:
        return torch.zeros(words.shape[0], dtype=torch.int64,
                           device=words.device)
    x = words ^ words[:, :1]
    vary = torch.stack([((x >> (8 * d)) & 0xFF).ne(0).any(dim=1)
                        for d in range(8)], dim=1).to(torch.int64)
    return (vary << torch.arange(8, device=words.device)).sum(dim=1)


def _key_runs(nkeys: int) -> List[Tuple[int, int]]:
    """[lo, hi) runs of at most SORT_MAX_KEYS keys, one K24 launch each
    (one run when there are none): the first run's words hold ~row_valid
    and its keys, each later run's words follow with its own keys, so
    the words in order still order the rows by every key in turn."""
    return [(lo, min(lo + SORT_MAX_KEYS, nkeys))
            for lo in range(0, nkeys, SORT_MAX_KEYS)] or [(0, 0)]


def sort_encode_plain(parts: Sequence[SortPart],
                      descending: Sequence[bool],
                      nulls_first: Sequence[bool]):
    """Plain version of K24: (words [W, n] int64 holding the unsigned
    key words bit for bit, per-word masks of varying digits [W]), with
    the keys in runs as `_key_runs` lays them out."""
    keys, valid = _concat_parts(parts)
    n = (valid if valid is not None else keys[0][0]).shape[0]
    dev = (valid if valid is not None else keys[0][0]).device
    runs = []
    for lo, hi in _key_runs(len(keys)):
        rv = valid if lo == 0 else None
        pos_valid, layout, nwords = _sort_layout(
            rv is not None, [(d.dtype, m is not None) for d, m in keys[lo:hi]])
        words = torch.zeros((nwords, n), dtype=torch.int64, device=dev)
        if rv is not None:
            _place(words, (~rv).to(torch.int64), 1, pos_valid)
        for (data, mask), (rank, vpos, width), d, nf in zip(
                keys[lo:hi], layout, descending[lo:hi], nulls_first[lo:hi]):
            if mask is not None:
                _place(words, (mask if nf else ~mask).to(torch.int64), 1,
                       rank)
            _place(words, _value_code(data, mask, d), width, vpos)
        runs.append(words)
    words = runs[0] if len(runs) == 1 else torch.cat(runs)
    return words, _vary_digits(words)


def _ptrs_raw(xs) -> "ctypes.Array":
    return (ctypes.c_int64 * max(len(xs), 1))(*xs)


def _ptrs(ts) -> "ctypes.Array":
    return (ctypes.c_int64 * max(len(ts), 1))(
        *[0 if t is None else t.data_ptr() for t in ts])


def _i32s(xs) -> "ctypes.Array":
    return (ctypes.c_int32 * max(len(xs), 1))(*xs)


def _check_part_cols(parts: Sequence[SortPart], dev, what: str,
                     most: int = 2):
    """Raise unless there are 1 to `most` sources and every column and
    row_valid of them is a 1-D tensor on `dev` of its source's rows
    (made contiguous here); the later sources' data cast to the first's
    dtypes. Returns (columns per source, row_valid per source, rows per
    source)."""
    if not 1 <= len(parts) <= most:
        raise ValueError(f"{what}: 1 to {most} sources, got {len(parts)}")
    out_cols, out_valid, rows = [], [], []
    for i, (cols, valid) in enumerate(parts):
        n = (valid if valid is not None else
             cols[0][0] if cols else None)
        if n is None:
            raise ValueError(f"{what}: a source with no column and no "
                             "row_valid")
        n = n.shape[0]
        if valid is not None:
            valid = valid.contiguous()
            check_rows(valid, n, dev, (torch.bool,), f"{what}: row_valid")
        fixed = []
        for j, (d, m) in enumerate(cols):
            if i and d.dtype != parts[0][0][j][0].dtype:
                d = d.to(parts[0][0][j][0].dtype)
            d = d.contiguous()
            check_rows(d, n, dev, tuple(SORT_DTYPES), f"{what}: column {j}")
            if m is not None:
                m = m.contiguous()
                check_rows(m, n, dev, (torch.bool,), f"{what}: mask {j}")
            fixed.append((d, m))
        out_cols.append(fixed)
        out_valid.append(valid)
        rows.append(n)
    for cols, valid in zip(out_cols[1:], out_valid[1:]):
        if len(cols) != len(out_cols[0]) \
                or (valid is None) != (out_valid[0] is None) \
                or any((a[1] is None) != (b[1] is None)
                       for a, b in zip(cols, out_cols[0])):
            raise ValueError(f"{what}: the sources differ in their "
                             "columns, masks or row_valid")
    return out_cols, out_valid, rows


def _sort_encode_cuda(parts, descending, nulls_first):
    """K24, one launch per run of keys (`_key_runs`), each writing its
    own rows of the one words tensor."""
    from presto_tpu_torch.native import cuda
    dev = (parts[0][1] if parts[0][1] is not None
           else parts[0][0][0][0]).device
    cols, valids, rows = _check_part_cols(parts, dev, "sort_encode")
    n = sum(rows)
    plans = []
    for lo, hi in _key_runs(len(cols[0])):
        has_valid = lo == 0 and valids[0] is not None
        plans.append((lo, hi, has_valid) + _sort_layout(
            has_valid, [(d.dtype, m is not None) for d, m in cols[0][lo:hi]]))
    total = sum(p[-1] for p in plans)
    words = torch.empty((total, n), dtype=torch.int64, device=dev)
    digits = torch.zeros(total, dtype=torch.int64, device=dev)
    if n == 0:
        return words, digits
    lib = cuda.library("sort_encode")
    w0 = 0
    for lo, hi, has_valid, pos_valid, layout, nwords in plans:
        keys, second = cols[0][lo:hi], cols[-1][lo:hi]
        acc = torch.empty(2 * nwords, dtype=torch.int64, device=dev)
        status = lib.presto_sort_encode(
            _ptrs([d for d, _ in keys]), _ptrs([d for d, _ in second]),
            _ptrs([m for _, m in keys]), _ptrs([m for _, m in second]),
            _i32s([SORT_DTYPES[d.dtype][0] for d, _ in keys]),
            _i32s([int(bool(x)) for x in descending[lo:hi]]),
            _i32s([int(bool(x)) for x in nulls_first[lo:hi]]),
            _i32s([r for r, _, _ in layout]),
            _i32s([v for _, v, _ in layout]),
            _i32s([w for _, _, w in layout]), ctypes.c_int32(hi - lo),
            ctypes.c_void_p(valids[0].data_ptr() if has_valid else 0),
            ctypes.c_void_p(valids[-1].data_ptr() if has_valid else 0),
            ctypes.c_int32(pos_valid), ctypes.c_int32(nwords),
            ctypes.c_int64(rows[0]), ctypes.c_int64(n),
            ctypes.c_void_p(words[w0].data_ptr()),
            ctypes.c_void_p(acc.data_ptr()),
            ctypes.c_void_p(digits[w0].data_ptr()),
            ctypes.c_void_p(cuda.stream_ptr(dev)))
        cuda.check(lib, status, "sort_encode")
        SORT_ENCODE_KERNEL.launches += 1
        w0 += nwords
    return words, digits


def sort_encode(parts: Sequence[SortPart], descending: Sequence[bool],
                nulls_first: Sequence[bool]):
    """K24: the key words of the rows of one or two sources (rows of the
    second after the first's) and, per word, the 8-bit mask of digits
    that vary. A source is (keys, row_valid or None); a key is (data,
    mask or None), its operands its null rank (when it has a mask) and
    its canonical value under `descending` and `nulls_first`, after
    ~row_valid. The CUDA kernel on CUDA tensors, `sort_encode_plain`
    on CPU tensors."""
    first = parts[0][1] if parts[0][1] is not None else parts[0][0][0][0]
    if first.device.type == "cpu":
        return sort_encode_plain(parts, descending, nulls_first)
    return _sort_encode_cuda(parts, descending, nulls_first)


def _word_list(words) -> List[torch.Tensor]:
    return list(words.unbind(0)) if isinstance(words, torch.Tensor) \
        else list(words)


def radix_sort_plain(words, digits: Optional[torch.Tensor] = None,
                     flip: bool = False, sorted_first: bool = False):
    """Plain version of K25: (perm, sorted word 0 or None) by one stable
    torch.sort per word, the last word first (the digit masks change
    nothing in the result, so they are not read). Words are unsigned,
    or signed int64 with `flip`."""
    wl = _word_list(words)
    n = wl[0].shape[0]
    perm = torch.arange(n, device=wl[0].device)
    for w in reversed(wl):
        k = w[perm]
        order = torch.sort(k if flip else k ^ _I64_MIN, stable=True).indices
        perm = perm[order]
    return perm, (wl[0][perm] if sorted_first else None)


#: look-back epochs are 30 bits (csrc/lookback.cuh); 0 is the zeroed
#: words' epoch
LOOKBACK_EPOCHS = 1 << 30
#: the look-back scratch per (device, stream) of the chained scans of
#: K27, K33 and K9's count pass (csrc/lookback.cuh): [the ticket counter
#: (each kernel leaves it at 0), the status words of as many tiles as
#: the largest call had so far, the last epoch handed out]
_LOOKBACK_SCRATCH: dict = {}
#: held around a call's epoch and launches: host threads that share a
#: stream (a worker's tasks) would otherwise race on the epoch (and on
#: the callers' own per-stream scratch, such as K33's table)
LOOKBACK_LOCK = threading.Lock()


def lookback_scratch(dev, stream: int, tiles: int):
    """The look-back scratch for a call of `tiles` tiles on `stream`,
    with the call's epoch taken: [ticket, status, epoch]. Take it under
    LOOKBACK_LOCK. A larger status array replaces a smaller one (zeroed
    words carry epoch 0, which no call takes); when the epochs wrap the
    words are zeroed again."""
    hit = _LOOKBACK_SCRATCH.get((dev, stream))
    if hit is None:
        hit = [torch.zeros(1, dtype=torch.int64, device=dev), None, 0]
        _LOOKBACK_SCRATCH[(dev, stream)] = hit
    if hit[1] is None or hit[1].shape[0] < tiles:
        hit[1] = torch.zeros(tiles, dtype=torch.int64, device=dev)
    hit[2] += 1
    if hit[2] == LOOKBACK_EPOCHS:
        hit[1].zero_()
        hit[2] = 1
    return hit


#: K25's scratch per (device, stream): (the pass table, histograms and
#: bucket starts, zeroed once; the look-back status words, zeroed once
#: and grown with the tile count). The kernels leave both reusable: the
#: histograms and tickets at 0, the status words under an old epoch.
_RADIX_SCRATCH: dict = {}
#: held around a call's launches: host threads that share a stream (a
#: worker's tasks) would otherwise interleave two calls' launches over
#: one pass table
_RADIX_LOCK = threading.Lock()
#: most passes K25 runs: 8 digits of each of SORT_MAX_WORDS words
#: (csrc/radix_sort.cu MAX_PASSES); the pass table's layout in int32:
#: [npasses, epoch, ticket, pad, word[MAX], shift[MAX], ...]
RADIX_MAX_PASSES = 8 * SORT_MAX_WORDS


def radix_tiles(n: int, tile: int) -> int:
    """K25's tiles (one block each per pass) for `n` rows."""
    return -(-n // tile)


def _radix_scratch(lib, dev, stream: int, tiles: int):
    """K25's scratch for a call of `tiles` tiles on `stream`: the fixed
    part, and status words for at least that many tiles (a larger
    array replaces a smaller one; zeroed words carry epoch 0, which no
    pass uses)."""
    fixed, status = _RADIX_SCRATCH.get((dev, stream), (None, None))
    if fixed is None:
        fixed = torch.zeros(-(-lib.presto_radix_scratch_bytes() // 8),
                            dtype=torch.int64, device=dev)
    if status is None or status.shape[0] < 256 * tiles:
        status = torch.zeros(256 * tiles, dtype=torch.int64, device=dev)
    _RADIX_SCRATCH[(dev, stream)] = (fixed, status)
    return fixed, status


def radix_last_passes(dev) -> List[Tuple[int, int]]:
    """The passes K25's last call on `dev`'s current stream ran, as
    (word, shift) least significant first, read from its device pass
    table (a host read: for tests and measurements, not the sort)."""
    from presto_tpu_torch.native import cuda
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    fixed, _ = _RADIX_SCRATCH[(dev, cuda.stream_ptr(dev))]
    table = fixed[:2 + RADIX_MAX_PASSES].view(torch.int32).tolist()
    npasses = table[0]
    word = table[4:4 + RADIX_MAX_PASSES]
    shift = table[4 + RADIX_MAX_PASSES:4 + 2 * RADIX_MAX_PASSES]
    return list(zip(word[:npasses], shift[:npasses]))


def _radix_sort_cuda(words, flip, sorted_first):
    from presto_tpu_torch.native import cuda
    wl = _word_list(words)
    dev = wl[0].device
    n = wl[0].shape[0]
    for i, w in enumerate(wl):
        check_rows(w, n, dev, (torch.int64,), f"radix_sort: word {i}")
    if not 1 <= len(wl) <= SORT_MAX_WORDS:
        raise ValueError(f"radix_sort: 1 to {SORT_MAX_WORDS} key words, got "
                         f"{len(wl)}")
    if n > RADIX_MAX_ROWS:
        raise ValueError(f"radix_sort: {n} rows; the 32-bit row index "
                         f"holds at most {RADIX_MAX_ROWS}")
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    sorted0 = torch.empty(n, dtype=torch.int64, device=dev) \
        if sorted_first else None
    if n == 0:
        return perm, sorted0
    lib = cuda.library("radix_sort")
    stream = cuda.stream_ptr(dev)
    keys = torch.empty(2 * n, dtype=torch.int64, device=dev)
    idx = torch.empty(2 * n, dtype=torch.int32, device=dev)
    with _RADIX_LOCK:
        fixed, status = _radix_scratch(
            lib, dev, stream, radix_tiles(n, lib.presto_radix_tile()))
        status_code = lib.presto_radix_sort(
            _ptrs(wl), ctypes.c_int32(len(wl)), ctypes.c_int64(n),
            ctypes.c_uint64(1 << 63 if flip else 0),
            ctypes.c_void_p(perm.data_ptr()),
            ctypes.c_void_p(0 if sorted0 is None else sorted0.data_ptr()),
            ctypes.c_void_p(keys.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
            ctypes.c_void_p(fixed.data_ptr()),
            ctypes.c_void_p(status.data_ptr()), ctypes.c_void_p(stream))
    cuda.check(lib, status_code, "radix_sort")
    RADIX_SORT_KERNEL.launches += 1
    return perm, sorted0


def radix_sort(words, flip: bool = False, sorted_first: bool = False):
    """K25: the stable permutation that orders rows by their key words
    (a [W, n] tensor or a list of W tensors, word 0 most significant),
    and with `sorted_first` word 0 in that order (the join build's
    sorted hashes). Words are unsigned 64-bit codes held in int64, or
    signed int64 with `flip`. The kernel finds the digits that vary
    from its own histograms (the passes `radix_passes` gives for K24's
    masks) and reads nothing on the host. The CUDA kernel on CUDA
    tensors, `radix_sort_plain` on CPU tensors."""
    if _word_list(words)[0].device.type == "cpu":
        return radix_sort_plain(words, None, flip, sorted_first)
    return _radix_sort_cuda(words, flip, sorted_first)


def gather_rows_plain(parts: Sequence[SortPart], perm: torch.Tensor,
                      rows: Optional[int] = None, limit=None):
    """Plain version of K26: (columns, row_valid or None) of the first
    `rows` entries of `perm` over the sources' rows (the second's after
    the first's). Output row j is live when its row is (or always,
    without a row_valid) and, with `limit` (an int or a 0-d tensor),
    j < limit; with a limit every mask is ANDed with that liveness."""
    cols, valid = _concat_parts(parts)
    p = perm if rows is None else perm[:rows]
    live = None
    if valid is not None or limit is not None:
        live = valid[p] if valid is not None else torch.ones(
            p.shape[0], dtype=torch.bool, device=p.device)
        if limit is not None:
            live = live & (torch.arange(p.shape[0], device=p.device) < limit)
    out = []
    for d, m in cols:
        om = None if m is None else m[p]
        if om is not None and limit is not None:
            om = om & live
        out.append((d[p], om))
    return out, live


#: launches of K26 that read more than two sources (a merge's partial
#: states, hashagg_merge), counted beside GATHER_ROWS_KERNEL
GATHER_SOURCES_KERNEL = _tk.LaunchCounter("gather_rows_sources",
                                          "hashagg_merge")
#: most (array, source) addresses one K26 launch takes
GATHER_MAX_SLOTS = 128


#: K26's limit given as an int: the last value per device and its
#: device scalar (the kernel only reads it; a topn step passes the same
#: n every batch)
_LIMITS: dict = {}


def _limit_scalar(n: int, dev) -> torch.Tensor:
    hit = _LIMITS.get(dev)
    if hit is None or hit[0] != n:
        hit = (n, torch.full((), n, dtype=torch.int64, device=dev))
        _LIMITS[dev] = hit
    return hit[1]


#: bytes of one K26 record (csrc/gather_rows.cu REC_WORDS x 4)
GATHER_RECORD_BYTES = 32
#: what one random read of HBM costs the card, in bytes of sequential
#: traffic (two 32-byte sectors; fits the sweep of chip_smoke.py
#: `measure_gather_sweep` on the H100: records pay from ~15% far rows at
#: 2^24 rows of ORDER_LINES' arrays, ~36% at 2^22, never at 2^21)
GATHER_RANDOM_BYTES = 64
#: the card's L2 (H100: 50 MB): sources that fit it are read where they
#: lie, and of larger ones only the share beyond it costs HBM reads
GATHER_L2_BYTES = 50 << 20
#: adjacent pairs of the permutation every K26 block samples, and the
#: rows apart beyond which a pair counts as far (csrc/gather_rows.cu
#: PROBE, NEAR)
GATHER_PROBE = 256
GATHER_NEAR = 8


def gather_launches(count: int, nsrc: int) -> List[Tuple[int, int]]:
    """K26's launches for `count` arrays of `nsrc` sources: [lo, hi) of
    each (at most GATHER_MAX_ARRAYS arrays and GATHER_MAX_SLOTS source
    addresses a launch; one launch with no array when there is none)."""
    per = min(GATHER_MAX_ARRAYS, GATHER_MAX_SLOTS // nsrc)
    return [(lo, min(lo + per, count)) for lo in range(0, max(count, 1), per)]


def gather_plan(sizes: Sequence[int], bools: Sequence[bool],
                valid_read: bool, rows: int, src_rows: int,
                stage: Optional[bool] = None):
    """K26's layout of one launch's arrays (csrc/gather_rows.cu `Plan`):
    (groups, need). Groups are (stride, [(array, byte, bit), ...]), the
    staged ones first. `sizes[c]` is array c's element bytes, `bools[c]`
    whether it is a bool array (a mask or a BOOLEAN column);
    `valid_read`: the launch reads the sources' row_valid.

    The arrays are packed into records of at most GATHER_RECORD_BYTES,
    the wider elements first (each at an offset aligned to its width),
    then the bools, one bit each (`bit`; -1 for a whole element). A
    record of two or more arrays is a staged group: the pre-pass writes
    it for every live source row (16 or 32 bytes, its `stride`) and the
    gather reads it once a live row; a lone array is a group of stride
    0, read where it lies.

    Whether the records run is the kernel's to see: `need` is the count
    of far pairs among the GATHER_PROBE it samples (`gather_far`) from
    which the random reads they save, one each per array they replace
    and per far row (row_valid's among them: a staged launch reads it
    from a bitmap in the L2), times the share of the sources beyond the
    L2, outweigh the pre-pass's bytes. Nothing is staged where that
    could not happen even with every row far (sources that fit the L2
    among them). `stage` True stages with need 0 (always), False
    never."""
    direct = ([(0, [(c, 0, -1)]) for c in range(len(sizes))], 0)
    reads = len(sizes) + int(valid_read)
    src_bytes = src_rows * (sum(sizes) + int(valid_read))
    beyond = src_bytes - GATHER_L2_BYTES
    # at best one read a row in place of every array's: where even that
    # does not pay for reading the arrays once, nothing is staged
    if stage is False or stage is None and (
            beyond <= 0 or rows * (reads - 1) * GATHER_RANDOM_BYTES * beyond
            < src_bytes * src_bytes):
        return direct
    bins: list = []  # [bytes used, members]

    def room(need):
        b = next((b for b in bins
                  if b[0] + need <= GATHER_RECORD_BYTES), None)
        if b is None:
            b = [0, []]
            bins.append(b)
        return b
    for c in sorted((c for c, b in enumerate(bools) if not b),
                    key=lambda c: -sizes[c]):
        b = room(sizes[c])
        b[1].append((c, b[0], -1))
        b[0] += sizes[c]
    byte = None  # [bin, byte, next bit] of the bools
    for c in (c for c, b in enumerate(bools) if b):
        if byte is None or byte[2] == 8:
            b = room(1)
            byte = [b, b[0], 0]
            b[0] += 1
        byte[0][1].append((c, byte[1], byte[2]))
        byte[2] += 1
    staged = [b for b in bins if len(b[1]) > 1]
    if not staged:
        return direct
    stride = [16 if b[0] <= 16 else 32 for b in staged]
    groups = [(w, b[1]) for w, b in zip(stride, staged)] + [
        (0, b[1]) for b in bins if len(b[1]) == 1]
    if stage:
        return groups, 0
    # far samples (of GATHER_PROBE) at which far rows x reads saved x
    # GATHER_RANDOM_BYTES x the share beyond the L2 reach the
    # pre-pass's bytes
    cost = src_rows * (sum(sizes[c] for b in staged for c, _, _ in b[1])
                       + sum(stride)) * src_bytes
    gain = rows * (reads - len(bins)) * GATHER_RANDOM_BYTES * beyond
    need = max(1, -(-cost * GATHER_PROBE // gain))
    return (groups, need) if need <= GATHER_PROBE else direct


def gather_far(perm: torch.Tensor, rows: int) -> int:
    """The far pairs K26's probe counts over the first `rows` entries of
    `perm` (csrc/gather_rows.cu `stage_runs`): pairs (perm[j], perm[j +
    1]) more than GATHER_NEAR rows apart, thread t's j in the t-th of
    GATHER_PROBE segments of [0, rows - 1) at a hashed offset. A host
    read: for tests and measurements."""
    if rows < 2:
        return 0
    seg = (rows - 1) // GATHER_PROBE
    j = [t * seg + ((((t + 1) * 0x9E3779B97F4A7C15) & (2 ** 64 - 1)) >> 11)
         % seg if seg else t * (rows - 1) // GATHER_PROBE
         for t in range(GATHER_PROBE)]
    j = torch.tensor(j, device=perm.device)
    return int(((perm[j + 1] - perm[j]).abs() > GATHER_NEAR).sum())


def gather_launch_plans(cols, has_valid: bool, limit_given: bool,
                        rows: int, src_rows: int, nsrc: int,
                        stage: Optional[bool] = None):
    """K26's launches for a call: per launch ([lo, hi) of its arrays,
    its `gather_plan` (groups, need), whether it reads row_valid).
    `cols` are the first source's (data, mask) pairs; the arrays are
    each column's data, then its mask where it has one. A launch reads
    the sources' row_valid, where they have one, when it writes the
    output row_valid (the first) or ANDs a mask with liveness (every
    mask under a limit)."""
    sizes, bools, ands = [], [], []
    for d, m in cols:
        sizes.append(d.element_size())
        bools.append(d.dtype == torch.bool)
        ands.append(False)
        if m is not None:
            sizes.append(1)
            bools.append(True)
            ands.append(limit_given)
    plans = []
    for lo, hi in gather_launches(len(sizes), nsrc):
        valid_read = has_valid and (lo == 0 or any(ands[lo:hi]))
        plans.append(((lo, hi), gather_plan(sizes[lo:hi], bools[lo:hi],
                                            valid_read, rows, src_rows,
                                            stage), valid_read))
    return plans


def _gather_rows_cuda(parts, perm, rows, limit, stage=None):
    from presto_tpu_torch.native import cuda
    dev = perm.device
    cols, valids, nrows = _check_part_cols(parts, dev, "gather_rows",
                                           MAX_SOURCES)
    rows = perm.shape[0] if rows is None else int(rows)
    if not 0 <= rows <= perm.shape[0]:
        raise ValueError(f"gather_rows: {rows} rows of a permutation of "
                         f"{perm.shape[0]}")
    check_rows(perm, perm.shape[0], dev, (torch.int64,),
               "gather_rows: permutation")
    has_valid = valids[0] is not None
    out_valid = torch.empty(rows, dtype=torch.bool, device=dev) \
        if has_valid or limit is not None else None
    # every array: [destination, bytes, AND with liveness, its sources'
    # addresses], a column's data then its mask
    and_live = int(limit is not None)
    arrays, out = [], []
    for j, (d, m) in enumerate(cols[0]):
        od = torch.empty(rows, dtype=d.dtype, device=dev)
        arrays.append([od.data_ptr(), d.element_size(), 0,
                       *(c[j][0].data_ptr() for c in cols)])
        om = None
        if m is not None:
            om = torch.empty(rows, dtype=torch.bool, device=dev)
            arrays.append([om.data_ptr(), 1, and_live,
                           *(c[j][1].data_ptr() for c in cols)])
        out.append((od, om))
    if rows == 0:
        return out, out_valid
    if limit is not None:
        limit = _limit_scalar(int(limit), dev) \
            if not isinstance(limit, torch.Tensor) \
            else limit.reshape(()).to(torch.int64).contiguous()
    nsrc = len(parts)
    offs = [0]
    for n in nrows:
        offs.append(offs[-1] + n)
    total = offs[-1]
    head = [*offs, *(0 if v is None else v.data_ptr() for v in valids)]
    lib = cuda.library("gather_rows")
    stream = cuda.stream_ptr(dev)
    for (lo, hi), (groups, need), _ in gather_launch_plans(
            cols[0], has_valid, limit is not None, rows, total, nsrc, stage):
        run = arrays[lo:hi]
        first = lo == 0
        recs = sum(g[0] for g in groups)
        # the records, then the live bitmap (one allocation)
        buf = torch.empty(total * recs + (-(-total // 32) * 4 if has_valid
                                          else 0),
                          dtype=torch.uint8, device=dev) if recs else None
        base = 0 if buf is None else buf.data_ptr()
        desc = [nsrc, len(groups), sum(1 for g in groups if g[0]),
                len(run), base + total * recs if recs and has_valid else 0,
                need, *head]
        # per group (stride, first array, records), then per array (dst,
        # bytes, byte, bit, and_live, sources)
        tail, at, k = [], 0, 0
        for stride, members in groups:
            desc += (stride, k, base + total * at if stride else 0)
            at += stride
            k += len(members)
            for c, byte, bit in members:
                a = run[c]
                tail += (a[0], a[1], byte, bit, *a[2:])
        # an int64 array.array: a fifth of a ctypes array's host time
        desc = array.array("q", desc + tail)
        status = lib.presto_gather_rows(
            desc.buffer_info()[0], perm.data_ptr(), rows,
            out_valid.data_ptr() if first and out_valid is not None else 0,
            0 if limit is None else limit.data_ptr(), stream)
        cuda.check(lib, status, "gather_rows")
        GATHER_ROWS_KERNEL.launches += 1
        if nsrc > 2:
            GATHER_SOURCES_KERNEL.launches += 1
    return out, out_valid


def gather_rows(parts: Sequence[SortPart], perm: torch.Tensor,
                rows: Optional[int] = None, limit=None):
    """K26: every column (data and mask) and row_valid of up to
    MAX_SOURCES sources moved through `perm` in one call (see
    `gather_rows_plain`); the later sources need no concatenation. The
    kernel stages records where its probe of `perm` finds the rows far
    apart enough to pay (`gather_plan`). The CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if perm.device.type == "cpu":
        return gather_rows_plain(parts, perm, rows, limit)
    return _gather_rows_cuda(parts, perm, rows, limit)


# -- topn's order: K31 topn_select, K32 topn_sort ----------------------------
#
# A topn step keeps the first C = state.capacity entries of the stable
# order of state ++ batch by K24's words. K31 narrows the N rows to at
# most M candidates that hold those C (a radix select, most significant
# digit first), K32 sorts the candidates in one block's shared memory,
# and K26 moves the C rows: the order of all N rows is never built.

#: launches of the radix select (csrc/topn_select.cu)
TOPN_SELECT_KERNEL = _tk.LaunchCounter("topn_select", "topn")
#: launches of the one-block candidate sort (csrc/topn_select.cu)
TOPN_SORT_KERNEL = _tk.LaunchCounter("topn_sort", "topn")
#: shared memory one block may opt into on the H100 (227 KB)
TOPN_SMEM_BYTES = 232_448
#: K32's shared memory besides M x (8W + 4) bytes of words and indices
#: (csrc/topn_select.cu SORT_SCRATCH)
TOPN_SORT_SCRATCH = 22_016
#: most candidates K32 sorts (csrc/topn_select.cu SORT_MAX_ROWS)
TOPN_SORT_MAX_ROWS = 8_192
#: K31's row states (csrc/topn_select.cu RowState)
_ST_OUT, _ST_BELOW, _ST_EQ = 0, 1, 2


def topn_plan(cap: int, nwords: int) -> Tuple[int, bool]:
    """(M, shared) of a topn step that keeps `cap` rows ordered by
    `nwords` key words: the candidate cap M (>= cap) and whether K32
    sorts the candidates in shared memory, which it does where M x
    (8 nwords + 4) bytes fit beside its scratch with M >= cap; M is then
    2 cap or the most that fits. Otherwise M = 2 cap and K25 sorts the
    candidates' words."""
    fit = min((TOPN_SMEM_BYTES - TOPN_SORT_SCRATCH) // (8 * nwords + 4),
              TOPN_SORT_MAX_ROWS)
    if fit >= cap:
        return min(fit, 2 * cap), True
    return 2 * cap, False


def _digit_order(nwords: int) -> List[Tuple[int, int]]:
    """(word, shift) of every 8-bit digit, most significant first."""
    return [(w, 8 * b) for w in range(nwords) for b in range(7, -1, -1)]


def topn_select_plain(words: torch.Tensor, digits: torch.Tensor, cap: int,
                      most: int):
    """Plain version of K31 over words [W, N] (N > most >= cap): (cand
    [most] int64: the candidates' row indices in index order, then -1;
    info [4] int64: candidates, passes, digits ran out, rows below;
    their words [W, most], padded with all-ones words). The same passes
    as the kernel: per varying digit, most significant first, a
    bincount of the EQUAL rows and the bucket holding rank cap - below,
    until below + equal <= most."""
    nwords, n = words.shape
    dev = words.device
    status = torch.full((n,), _ST_EQ, dtype=torch.int8, device=dev)
    below, eq, passes = 0, n, 0
    masks = [int(x) for x in digits.tolist()]
    for w, shift in _digit_order(nwords):
        if not (masks[w] >> (shift // 8)) & 1 or below + eq <= most:
            continue
        d = (words[w] >> shift) & 0xFF
        live = status == _ST_EQ
        hist = torch.bincount(d[live], minlength=256)
        incl = torch.cumsum(hist, 0)
        b = int(torch.searchsorted(incl, cap - below))
        below += int(incl[b] - hist[b])
        eq = int(hist[b])
        passes += 1
        status = torch.where(live & (d < b), _ST_BELOW, torch.where(
            live & (d > b), _ST_OUT, status)).to(torch.int8)
    ran_out = below + eq > most
    limit = cap - below if ran_out else eq
    is_eq = status == _ST_EQ
    eq_rank = torch.cumsum(is_eq.to(torch.int64), 0) - 1
    keep = (status == _ST_BELOW) | (is_eq & (eq_rank < limit))
    rows = torch.nonzero(keep).flatten()
    count = rows.shape[0]
    cand = torch.full((most,), -1, dtype=torch.int64, device=dev)
    cand[:count] = rows
    info = torch.tensor([count, passes, int(ran_out), below],
                        dtype=torch.int64, device=dev)
    cwords = torch.full((nwords, most), -1, dtype=torch.int64, device=dev)
    cwords[:, :count] = words[:, rows]
    return cand, info, cwords


def _topn_select_cuda(words, digits, cap, most):
    from presto_tpu_torch.native import cuda
    dev = words.device
    nwords, n = words.shape
    if words.dim() != 2 or words.dtype != torch.int64 \
            or not words.is_contiguous():
        raise ValueError("topn_select: the words must be one contiguous "
                         f"[W, N] int64 tensor; got {words.dtype} "
                         f"{tuple(words.shape)}")
    check_rows(digits, nwords, dev, (torch.int64,), "topn_select: digits")
    if not 1 <= cap <= most < n or n > RADIX_MAX_ROWS \
            or not 1 <= nwords <= SORT_MAX_WORDS:
        raise ValueError(f"topn_select: needs 1 <= C <= M < N and N <= "
                         f"{RADIX_MAX_ROWS}; got C={cap} M={most} N={n}, "
                         f"{nwords} words")
    lib = cuda.library("topn_select")
    size = -(-lib.presto_topn_select_scratch(n, nwords) // 8)
    # one allocation: the scratch first (its row states are read 16
    # bytes at a time, from the allocation's aligned start), then the
    # candidates, info and their words
    buf = torch.empty(size + most * (nwords + 1) + 4, dtype=torch.int64,
                      device=dev)
    scratch, out = buf[:size], buf[size:]
    cand, info = out[:most], out[most:most + 4]
    cwords = out[most + 4:].view(nwords, most)
    status = lib.presto_topn_select(
        ctypes.c_void_p(words.data_ptr()), ctypes.c_int32(nwords),
        ctypes.c_int64(n), ctypes.c_int64(cap), ctypes.c_int64(most),
        ctypes.c_void_p(digits.data_ptr()),
        ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(cand.data_ptr()),
        ctypes.c_void_p(cwords.data_ptr()),
        ctypes.c_void_p(info.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "topn_select")
    TOPN_SELECT_KERNEL.launches += 1
    return cand, info, cwords


def topn_select(words: torch.Tensor, digits: torch.Tensor, cap: int,
                most: int):
    """K31: the radix select of the candidates that hold the first `cap`
    rows of the stable order of words [W, N] (K24's, with its digit
    masks), at most `most` of them, and their words compacted (see
    `topn_select_plain`); no host read. The CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if words.device.type == "cpu":
        return topn_select_plain(words, digits, cap, most)
    return _topn_select_cuda(words, digits, cap, most)


def topn_sort_plain(keys: torch.Tensor, cand: Optional[torch.Tensor],
                    info: Optional[torch.Tensor], cap: int,
                    most: Optional[int] = None) -> torch.Tensor:
    """Plain version of K32: the first `cap` row indices (int64) of the
    stable order of the candidates by their words: K31's candidates'
    words keys [W, most] with `cand` and its count info[0], or, without
    them, the words [W, N] of every row. By stable torch.sort passes;
    `most` (the kernel's shared-memory size) is not read."""
    if cand is None:
        local, _ = radix_sort_plain(keys)
        return local[:cap]
    count = int(info[0])
    local, _ = radix_sort_plain(keys[:, :count])
    return cand[local[:cap]]


def _topn_sort_cuda(keys, cand, info, cap, most):
    from presto_tpu_torch.native import cuda
    dev = keys.device
    nwords, stride = keys.shape
    if keys.dtype != torch.int64 or not keys.is_contiguous():
        raise ValueError("topn_sort: the words must be one contiguous "
                         f"[W, rows] int64 tensor; got {keys.dtype}")
    if cand is not None:
        check_rows(cand, most, dev, (torch.int64,), "topn_sort: candidates")
        check_rows(info, 4, dev, (torch.int64,), "topn_sort: info")
        if stride != most:
            raise ValueError(f"topn_sort: the candidates' words hold "
                             f"{stride} rows, not M={most}")
    elif stride > most:
        raise ValueError(f"topn_sort: {stride} rows without a select, at "
                         f"most M={most}")
    if not 1 <= cap <= most <= TOPN_SORT_MAX_ROWS or most * (
            8 * nwords + 4) + TOPN_SORT_SCRATCH > TOPN_SMEM_BYTES:
        raise ValueError(f"topn_sort: M={most} candidates of {nwords} words "
                         "do not fit one block's shared memory")
    perm = torch.empty(cap, dtype=torch.int64, device=dev)
    lib = cuda.library("topn_select")
    status = lib.presto_topn_sort(
        ctypes.c_void_p(keys.data_ptr()), ctypes.c_int32(nwords),
        ctypes.c_int64(stride),
        ctypes.c_void_p(0 if cand is None else cand.data_ptr()),
        ctypes.c_void_p(0 if cand is None else info.data_ptr()),
        ctypes.c_int64(most), ctypes.c_int64(cap),
        ctypes.c_void_p(perm.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "topn_sort")
    TOPN_SORT_KERNEL.launches += 1
    return perm


def topn_sort(keys: torch.Tensor, cand: Optional[torch.Tensor],
              info: Optional[torch.Tensor], cap: int,
              most: int) -> torch.Tensor:
    """K32: the first `cap` row indices of the stable order of K31's
    candidates by their words (`keys`, K31's compacted copy), or of all
    N <= `most` rows when `cand` is None (`keys` the words themselves),
    sorted in one block's shared memory. The CUDA kernel on CUDA
    tensors, `topn_sort_plain` on CPU tensors."""
    if keys.device.type == "cpu":
        return topn_sort_plain(keys, cand, info, cap, most)
    return _topn_sort_cuda(keys, cand, info, cap, most)


def topn_order(words: torch.Tensor, digits: torch.Tensor,
               cap: int) -> torch.Tensor:
    """The first `cap` entries of the stable order of words [W, N]
    (N >= cap): K31 selects at most M candidates (skipped when N <= M)
    and K32 sorts them; where K32's shared memory cannot hold M >= cap
    candidates (`topn_plan`), K25 sorts the candidates' words and K26
    maps the order back to rows. On CPU tensors the plain versions."""
    nwords, n = words.shape
    most, shared = topn_plan(cap, nwords)
    if n <= most:
        if shared or words.device.type == "cpu":
            return topn_sort(words, None, None, cap, most)
        return radix_sort(words)[0][:cap]
    cand, info, cwords = topn_select(words, digits, cap, most)
    if shared or words.device.type == "cpu":
        return topn_sort(cwords, cand, info, cap, most)
    local, _ = radix_sort(cwords)
    out, _ = gather_rows([([(cand, None)], None)], local, rows=cap)
    return out[0][0]


def sort_rows(keys: Sequence[CVal],
              descending: Optional[Sequence[bool]] = None,
              nulls_first: Optional[Sequence[bool]] = None,
              valid: Optional[torch.Tensor] = None,
              payloads: Sequence[torch.Tensor] = ()):
    """Lexicographic sort carrying payloads. Sort operands per key are
    (null_rank, canonical_value) so SQL null ordering and NULL==NULL
    grouping hold; `valid=False` rows sort to the end. Returns
    (sorted_keys, sorted_valid, sorted_payloads). On CUDA tensors K24,
    K25 and K26 (one launch each for up to 32 carried columns); on CPU
    tensors stable torch.sort passes and indexing."""
    desc = descending or [False] * len(keys)
    nf = nulls_first or [False] * len(keys)
    if not keys and valid is None:
        return list(keys), valid, list(payloads)
    on_cpu = (valid if valid is not None else keys[0][0]).device.type \
        == "cpu"
    return (_sort_rows_plain if on_cpu else _sort_rows_kernels)(
        keys, desc, nf, valid, payloads)


def _sort_rows_plain(keys, desc, nf, valid, payloads):
    """`sort_rows` by stable torch.sort passes and indexing."""
    sort_ops: List[torch.Tensor] = []
    if valid is not None:
        sort_ops.append(~valid)
    for (data, mask), d, nfirst in zip(keys, desc, nf):
        sort_ops.extend(key_sort_ops(data, mask, d, nfirst))
    perm = _stable_order(sort_ops)
    skeys = [(d[perm], m[perm]) for d, m in keys]
    svalid = None if valid is None else valid[perm]
    return skeys, svalid, [p[perm] for p in payloads]


def _sort_rows_kernels(keys, desc, nf, valid, payloads):
    """`sort_rows` as K24 (the operands above as key words), K25 (the
    permutation) and K26 (every key and payload moved in one launch)."""
    words, _ = sort_encode([(keys, valid)], desc, nf)
    perm, _ = radix_sort(words)
    cols = list(keys) + [(p, None) for p in payloads]
    out, svalid = gather_rows([(cols, valid)], perm)
    return out[:len(keys)], svalid, [d for d, _ in out[len(keys):]]


def boundaries(sorted_keys: Sequence[CVal],
               sorted_valid: torch.Tensor,
               hashes: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
    """True where a new group starts (first valid row or key change),
    over rows already in group order. NULLs compare equal for
    grouping. `hashes` (in the same sorted order) extend the adjacent
    compare for hash-ordered grouping, where equal keys are adjacent
    because rows are sorted by (hashes) rather than by the keys."""
    n = sorted_valid.shape[0]
    change = torch.zeros(n, dtype=torch.bool, device=sorted_valid.device)
    change[0] = True
    for h in (hashes or ()):
        change = change | (h != torch.roll(h, 1))
    for data, mask in sorted_keys:
        prev_d = torch.roll(data, 1)
        prev_m = torch.roll(mask, 1)
        differs = (data != prev_d) | (mask != prev_m)
        differs = differs & ~(~mask & ~prev_m)
        change = change | differs
    prev_valid = torch.roll(sorted_valid, 1)
    prev_valid[0] = False
    return sorted_valid & (change | ~prev_valid)
