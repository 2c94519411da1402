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

import ctypes
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


def key_args(keys: Sequence[CVal], n: int, dev: torch.device,
             what: str):
    """Check key columns for a CUDA kernel that hashes them and build
    the ctypes host arrays (data pointers, mask pointers, dtype codes)
    of csrc/row_hash.cuh's `KeyCols`."""
    if not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"{what}: 1 to {MAX_KEYS} key columns, got "
                         f"{len(keys)}")
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
    P = ctypes.c_int64 * MAX_KEYS
    return (P(*[d.data_ptr() for d, _ in keys]),
            P(*[m.data_ptr() for _, m in keys]),
            (ctypes.c_int32 * MAX_KEYS)(*[KEY_DTYPES[d.dtype]
                                          for d, _ in keys]),
            ctypes.c_int32(len(keys)))


def key_groups(keys: Sequence[CVal]) -> List[Sequence[CVal]]:
    """Successive runs of at most MAX_KEYS key columns, in key order."""
    return [keys[lo:lo + MAX_KEYS] for lo in range(0, len(keys), MAX_KEYS)]


def key_group_args(keys: Sequence[CVal], n: int, dev: torch.device,
                   what: str):
    """`key_args` for a kernel that compares groups of key columns in
    turn (csrc/row_hash.cuh `KeyGroups`): each group is checked as
    `key_args` checks it, and the tables are passed flat, group after
    group, with the total key count. Past MAX_KEY_GROUPS groups the later
    groups also go to the device as a descriptor of one KeyCols (21
    int64 words) each, whose address follows the last key's in the data
    table. Returns (data, masks, dtypes, count, the descriptor tensor or
    None): the caller holds the last until its launch is queued."""
    if not keys:
        raise ValueError(f"{what}: no key columns")
    groups = key_groups(keys)
    tables = [key_args(g, n, dev, what) for g in groups]
    flat = [[t[f][j] for t, g in zip(tables, groups) for j in range(len(g))]
            for f in range(3)]
    nk = len(keys)
    desc = None
    if len(groups) > MAX_KEY_GROUPS:
        rows = np.zeros((len(groups) - MAX_KEY_GROUPS, 21), dtype=np.int64)
        for r, (t, g) in enumerate(zip(tables[MAX_KEY_GROUPS:],
                                       groups[MAX_KEY_GROUPS:])):
            rows[r, 0:8] = list(t[0])
            rows[r, 8:16] = list(t[1])
            rows[r, 16:20] = np.array(list(t[2]), dtype=np.int32) \
                .view(np.int64)
            rows[r, 20] = len(g)
        desc = torch.from_numpy(rows)
        if dev.type == "cuda":
            desc = desc.pin_memory().to(dev, non_blocking=True)
        flat[0].append(desc.data_ptr())
    return (*((ctypes.c_int64 * len(f))(*f) for f in flat[:2]),
            (ctypes.c_int32 * nk)(*flat[2]), ctypes.c_int32(nk), desc)


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

#: key dtype -> (code of csrc/sort_encode.cu `SortDtype`, bits of its
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
    the same on every row."""
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
    straddles them (csrc/sort_encode.cu `Packer::put`)."""
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
            if i:
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


def _radix_sort_cuda(words, digits, flip, sorted_first):
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
    # the one host read of a sort: which digits vary (K24's masks)
    masks = [0xFF] * len(wl) if digits is None else digits.tolist()
    passes = radix_passes(masks)
    lib = cuda.library("radix_sort")
    tile = lib.presto_radix_tile()
    keys = torch.empty(2 * n, dtype=torch.int64, device=dev)
    idx = torch.empty(2 * n, dtype=torch.int32, device=dev)
    hist = torch.empty(256 * (-(-n // tile)), dtype=torch.int32, device=dev)
    tot = torch.empty(256, dtype=torch.int32, device=dev)
    flat = [x for p in passes for x in p]
    status = lib.presto_radix_sort(
        _ptrs(wl), ctypes.c_int32(len(wl)), ctypes.c_int64(n),
        ctypes.c_uint64(1 << 63 if flip else 0), _i32s(flat),
        ctypes.c_int32(len(passes)), ctypes.c_void_p(perm.data_ptr()),
        ctypes.c_void_p(0 if sorted0 is None else sorted0.data_ptr()),
        ctypes.c_void_p(keys.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
        ctypes.c_void_p(hist.data_ptr()), ctypes.c_void_p(tot.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "radix_sort")
    RADIX_SORT_KERNEL.launches += 1
    return perm, sorted0


def radix_sort(words, digits: Optional[torch.Tensor] = None,
               flip: bool = False, sorted_first: bool = False):
    """K25: the stable permutation that orders rows by their key words
    (a [W, n] tensor or a list of W tensors, word 0 most significant),
    and with `sorted_first` word 0 in that order (the join build's
    sorted hashes). Words are unsigned 64-bit codes held in int64, or
    signed int64 with `flip`. `digits` (K24's masks) lets the sort skip
    the digits that do not vary; without them every digit is sorted.
    The CUDA kernel on CUDA tensors, `radix_sort_plain` on CPU
    tensors."""
    if _word_list(words)[0].device.type == "cpu":
        return radix_sort_plain(words, digits, flip, sorted_first)
    return _radix_sort_cuda(words, digits, flip, sorted_first)


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


def _gather_rows_cuda(parts, perm, rows, limit):
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
    first = cols[0]
    out = [(torch.empty(rows, dtype=d.dtype, device=dev),
            None if m is None else torch.empty(rows, dtype=torch.bool,
                                               device=dev))
           for d, m in first]
    out_valid = torch.empty(rows, dtype=torch.bool, device=dev) \
        if valids[0] is not None or limit is not None else None
    if rows == 0:
        return out, out_valid
    if limit is not None:
        limit = torch.full((), int(limit), dtype=torch.int64, device=dev) \
            if not isinstance(limit, torch.Tensor) \
            else limit.reshape(()).to(torch.int64).contiguous()
    nsrc = len(parts)
    offs = [0]
    for n in nrows:
        offs.append(offs[-1] + n)
    # arrays: (one address per source, destination, bytes, AND with
    # liveness)
    arrays = []
    for j, (od, om) in enumerate(out):
        arrays.append(([c[j][0] for c in cols], od, first[j][0]
                       .element_size(), 0))
        if om is not None:
            arrays.append(([c[j][1] for c in cols], om, 1,
                           int(limit is not None)))
    lib = cuda.library("gather_rows")
    per = min(GATHER_MAX_ARRAYS, GATHER_MAX_SLOTS // nsrc)
    for lo in range(0, max(len(arrays), 1), per):
        run = arrays[lo:lo + per]
        head = lo == 0
        status = lib.presto_gather_rows(
            _ptrs([t for a in run for t in a[0]]), ctypes.c_int32(nsrc),
            _ptrs_raw(offs), _ptrs(valids), _ptrs([a[1] for a in run]),
            _i32s([a[2] for a in run]), _i32s([a[3] for a in run]),
            ctypes.c_int32(len(run)), ctypes.c_void_p(perm.data_ptr()),
            ctypes.c_int64(rows),
            ctypes.c_void_p(0 if out_valid is None or not head
                            else out_valid.data_ptr()),
            ctypes.c_void_p(0 if limit is None else limit.data_ptr()),
            ctypes.c_void_p(cuda.stream_ptr(dev)))
        cuda.check(lib, status, "gather_rows")
        GATHER_ROWS_KERNEL.launches += 1
        if nsrc > 2:
            GATHER_SOURCES_KERNEL.launches += 1
    return out, out_valid


def gather_rows(parts: Sequence[SortPart], perm: torch.Tensor,
                rows: Optional[int] = None, limit=None):
    """K26: every column (data and mask) and row_valid of up to
    MAX_SOURCES sources moved through `perm` in one launch (see
    `gather_rows_plain`); the later sources need no concatenation.
    The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if perm.device.type == "cpu":
        return gather_rows_plain(parts, perm, rows, limit)
    return _gather_rows_cuda(parts, perm, rows, limit)


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
    words, digits = sort_encode([(keys, valid)], desc, nf)
    perm, _ = radix_sort(words, digits)
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
