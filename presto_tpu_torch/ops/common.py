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
#: most key groups one K5, K7, K8 or K9 launch compares
#: (PRESTO_MAX_KEY_GROUPS): those kernels take up to 24 key columns
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
    """`key_args` for a kernel that compares up to MAX_KEY_GROUPS groups
    of key columns in turn (csrc/row_hash.cuh `KeyGroups`): each group
    is checked as `key_args` checks it, and the tables are passed flat,
    group after group, with the total key count."""
    if not 1 <= len(keys) <= MAX_KEYS * MAX_KEY_GROUPS:
        raise ValueError(f"{what}: 1 to {MAX_KEYS * MAX_KEY_GROUPS} key "
                         f"columns, got {len(keys)}")
    groups = key_groups(keys)
    tables = [key_args(g, n, dev, what) for g in groups]
    flat = [[t[f][j] for t, g in zip(tables, groups) for j in range(len(g))]
            for f in range(3)]
    nk = len(keys)
    return (*((ctypes.c_int64 * nk)(*f) for f in flat[:2]),
            (ctypes.c_int32 * nk)(*flat[2]), ctypes.c_int32(nk))


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


def _row_hash_cuda(keys: Sequence[CVal], row_valid: torch.Tensor,
                   nulls_invalid: bool):
    """K3; more than MAX_KEYS keys are hashed MAX_KEYS at a time and
    chained: row_hash is linear in its parts (h = h_a * 31^m + h_b, m
    the keys of the later part, wrapping like the reference's uint64
    arithmetic), and likewise row_hash2 with 37, so the chained result
    equals the reference's bit for bit; the dead-row sentinels are
    folded in at the end."""
    if len(keys) <= MAX_KEYS:
        return _row_hash_launch(keys, row_valid, nulls_invalid)
    every = torch.ones_like(row_valid)
    h = h2 = None
    for lo in range(0, len(keys), MAX_KEYS):
        part = keys[lo:lo + MAX_KEYS]
        ph, ph2 = _row_hash_launch(part, every, False)
        if h is None:
            h, h2 = ph, ph2
        else:
            h = h * _s64(31 ** len(part)) + ph
            h2 = h2 * _s64(37 ** len(part)) + ph2
    live = row_valid
    if nulls_invalid:
        for _, m in keys:
            live = live & m
    h = torch.where(live, h, torch.full_like(h, H_INVALID))
    if nulls_invalid:
        h2 = torch.where(live, h2, torch.full_like(h2, H2_INVALID))
    return h, h2


def _row_hash_launch(keys: Sequence[CVal], row_valid: torch.Tensor,
                     nulls_invalid: bool):
    from presto_tpu_torch.native import cuda
    dev = row_valid.device
    n = row_valid.shape[0]
    check_rows(row_valid, n, dev, (torch.bool,), "row_hash: row_valid")
    kd, km, kt, nk = key_args(keys, n, dev, "row_hash")
    h = torch.empty(n, dtype=torch.int64, device=dev)
    h2 = torch.empty(n, dtype=torch.int64, device=dev)
    lib = cuda.library("row_hash")
    status = lib.presto_row_hash(
        kd, km, kt, nk, ctypes.c_void_p(row_valid.data_ptr()),
        ctypes.c_int64(n), ctypes.c_int32(int(nulls_invalid)),
        ctypes.c_void_p(h.data_ptr()), ctypes.c_void_p(h2.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "row_hash")
    ROW_HASH_KERNEL.launches += 1
    return h, h2


def row_hash_pair(keys: Sequence[CVal], row_valid: torch.Tensor,
                  nulls_invalid: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: both row hashes of every row, dead rows folded to their
    sentinels (see `row_hash_pair_plain`). The CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if row_valid.device.type == "cpu":
        return row_hash_pair_plain(keys, row_valid, nulls_invalid)
    return _row_hash_cuda(keys, row_valid, nulls_invalid)


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
    """Stable permutation ordering rows by `sort_ops` (most significant
    first)."""
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


def sort_rows(keys: Sequence[CVal],
              descending: Optional[Sequence[bool]] = None,
              nulls_first: Optional[Sequence[bool]] = None,
              valid: Optional[torch.Tensor] = None,
              payloads: Sequence[torch.Tensor] = ()):
    """Lexicographic sort carrying payloads. Sort operands per key are
    (null_rank, canonical_value) so SQL null ordering and NULL==NULL
    grouping hold; `valid=False` rows sort to the end. Returns
    (sorted_keys, sorted_valid, sorted_payloads)."""
    desc = descending or [False] * len(keys)
    nf = nulls_first or [False] * len(keys)
    sort_ops: List[torch.Tensor] = []
    if valid is not None:
        sort_ops.append(~valid)
    for (data, mask), d, nfirst in zip(keys, desc, nf):
        sort_ops.append(mask if nfirst else ~mask)
        sv = _negate_for_desc(data) if d else data
        sort_ops.append(torch.where(mask, sv, torch.zeros_like(sv)))
    if not sort_ops:
        return list(keys), valid, list(payloads)
    perm = _stable_order(sort_ops)
    skeys = [(d[perm], m[perm]) for d, m in keys]
    svalid = None if valid is None else valid[perm]
    return skeys, svalid, [p[perm] for p in payloads]


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
