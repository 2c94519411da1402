"""Window functions (reference: presto_tpu/ops/window.py; the Java
engine's WindowOperator.java:62 and operator/window/).

One whole-relation pass, no per-row loop: rows are lex-sorted by
(partition keys, order keys) with `common.sort_rows` (one `torch.sort`
per operand, carrying the argument columns and a row-index iota);
partition and peer boundaries come from adjacent compares; ranking
functions are position arithmetic over the boundary scans; framed
sums and counts are prefix-sum differences; framed min/max are range
queries; positional values gather at frame endpoints. Results scatter
back to input order (`out[iota_sorted] = v`, exact because the sorted
iota is a permutation; the reference sorted a second time because
scatters serialize on the TPU).

The hand-written CUDA kernels of this module (csrc/, sharing
`window_frame.cuh`, which turns (mode, start, end) and the per-row
segment positions into the frame [flo, fhi]):

- K13 `window_segments` (csrc/window_segments.cu): per row the
  partition id, partition start and end, peer-group start and end and
  the dense-rank prefix;
- K14 `window_frame_sum` (csrc/window_frame_sum.cu): framed count,
  sum and avg (integer sums wrap in int64; float sums through a
  double-double prefix with NaN / +Inf / -Inf counted exactly), the
  RANGE-offset frame bounds searched per row;
- K15 `window_frame_minmax` (csrc/window_frame_minmax.cu): framed min
  and max, NaN winning, over a blocked sparse table;
- K16 `window_emit` (csrc/window_emit.cu): ranking and positional
  functions and the scatter of every output column to input order.

Each has its plain PyTorch version here (the `*_plain` functions, the
reference's arithmetic), which runs for CPU tensors; the card's path
never calls them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.ops import common
from presto_tpu_torch.telemetry import kernels as _tk
from presto_tpu_torch.types import Type

CVal = Tuple[torch.Tensor, torch.Tensor]

#: legacy frame modes (still accepted; normalized by norm_frame)
FULL = "full"              # whole partition
ROWS_RUNNING = "rows"      # rows unbounded preceding..current row
RANGE_RUNNING = "range"    # + peers share their group's last value

#: frame bound encoding: "u" = UNBOUNDED, "c" = CURRENT ROW, a signed
#: number = offset (negative = PRECEDING, positive = FOLLOWING)
Bound = Union[str, int, float]


@dataclasses.dataclass(frozen=True)
class WindowCallSpec:
    """Static description of one window function call."""
    out_name: str
    function: str              # rank|ntile|sum|first_value|...
    arg: Optional[str]         # input column name (None for count(*))
    frame: str                 # "rows" | "range" | legacy mode consts
    out_type: Type = None
    out_dict: Optional[Tuple[str, ...]] = None
    offset: int = 1            # lag/lead distance; ntile/nth_value N
    fstart: Bound = "u"        # frame start bound
    fend: Bound = "c"          # frame end bound
    filter_arg: Optional[str] = None   # FILTER (WHERE ...) column
    default: Any = None        # lag/lead constant default value

    def norm_frame(self) -> Tuple[str, Bound, Bound]:
        """Normalize legacy mode constants to (mode, fstart, fend)."""
        if self.frame == FULL:
            return "rows", "u", "u"
        if self.frame == ROWS_RUNNING and self.fstart == "u" \
                and self.fend == "c":
            return "rows", "u", "c"
        if self.frame == RANGE_RUNNING:
            return "range", self.fstart, self.fend
        return self.frame, self.fstart, self.fend


RANKING = ("rank", "dense_rank", "row_number", "ntile", "percent_rank",
           "cume_dist")
POSITIONAL = ("lag", "lead", "first_value", "last_value", "nth_value")


@dataclasses.dataclass
class Segments:
    """K13's output, per sorted row (int64): partition id, start and
    last valid row; peer-group start and last valid row; the running
    count of peer-group starts (dense_rank's prefix). Padding rows
    sort last and carry the final group's ids and ends."""
    pid: torch.Tensor
    pstart: torch.Tensor
    part_end: torch.Tensor
    peer_start: torch.Tensor
    peer_end: torch.Tensor
    dense: torch.Tensor


@dataclasses.dataclass
class OrderKey:
    """The first ORDER BY key in sorted order: the value RANGE offset
    frames search (canonical: negated when DESC, NULLs pinned to the
    end they sort to)."""
    data: torch.Tensor
    mask: torch.Tensor
    descending: bool
    nulls_first: bool

    @property
    def is_float(self) -> bool:
        return self.data.dtype in (torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True)
class Frame:
    """A normalized frame: mode "rows" | "range", bounds as Bound."""
    mode: str
    start: Bound
    end: Bound


# -- plain versions -------------------------------------------------------


def _segment_max(vals: torch.Tensor, ids: torch.Tensor,
                 num: int) -> torch.Tensor:
    out = torch.full((num,), -1, dtype=torch.int64, device=vals.device)
    out.scatter_reduce_(0, ids, vals, "amax")
    return out


def segments_plain(spart: Sequence[CVal], sorder: Sequence[CVal],
                   svalid: torch.Tensor) -> Segments:
    """Plain version of K13 (the reference's `:198-221`)."""
    cap = svalid.shape[0]
    pos = torch.arange(cap, device=svalid.device)
    if spart:
        pbnd = common.boundaries(spart, svalid)
    else:
        pbnd = (pos == 0) & svalid
    pid = torch.clamp(torch.cumsum(pbnd.to(torch.int64), 0) - 1, min=0)
    pstart = torch.cummax(torch.where(pbnd, pos, 0), 0).values
    if sorder:
        peer_bnd = common.boundaries(list(spart) + list(sorder), svalid)
    else:
        peer_bnd = pbnd
    dense = torch.cumsum(peer_bnd.to(torch.int64), 0)
    peer_id = torch.clamp(dense - 1, min=0)
    peer_start = torch.cummax(torch.where(peer_bnd, pos, 0), 0).values
    live_pos = torch.where(svalid, pos, -1)
    peer_end = torch.clamp(
        _segment_max(live_pos, peer_id, cap + 1)[peer_id], min=0)
    part_end = torch.clamp(
        _segment_max(live_pos, pid, cap + 1)[pid], min=0)
    return Segments(pid, pstart, part_end, peer_start, peer_end, dense)


def canonical_order(order: Optional[OrderKey], cap: int,
                    device: torch.device):
    """(sv0, ok0): the first order key's canonical nondecreasing value
    within a partition and its not-NULL mask (the reference's
    `:223-240`)."""
    if order is None:
        return (torch.zeros(cap, dtype=torch.int64, device=device),
                torch.ones(cap, dtype=torch.bool, device=device))
    od, om = order.data, order.mask
    if order.is_float:
        v = od.to(torch.float64)
        null_sv = -math.inf if order.nulls_first else math.inf
    else:
        v = od.to(torch.int64)
        info = torch.iinfo(torch.int64)
        null_sv = info.min if order.nulls_first else info.max
    if order.descending:
        v = -v
    return torch.where(om, v, torch.full_like(v, null_sv)), om


def _range_offset(order: Optional[OrderKey], off):
    """A RANGE offset on the canonical scale's dtype (an integer key
    truncates a fractional offset, as the reference's asarray does)."""
    if order is not None and order.is_float:
        return float(off)
    return int(off)


def _part_searchsorted(sv: torch.Tensor, target: torch.Tensor,
                       pstart: torch.Tensor, pend: torch.Tensor,
                       side_left: bool) -> torch.Tensor:
    """Per-row binary search within [pstart[i], pend[i]]: first index j
    with sv[j] >= target[i] (side_left) or > target[i]."""
    n = sv.shape[0]
    lo = pstart
    hi = pend + 1
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))) + 1)):
        active = lo < hi
        mid = (lo + hi) // 2
        midv = sv[torch.clamp(mid, 0, n - 1)]
        go_left = (midv >= target) if side_left else (midv > target)
        hi = torch.where(active & go_left, mid, hi)
        lo = torch.where(active & ~go_left, mid + 1, lo)
    return lo


def frame_plain(seg: Segments, order: Optional[OrderKey],
                frame: Frame) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row inclusive frame positions [flo, fhi] (the reference's
    `frame_of`; window_frame.cuh on the card)."""
    cap = seg.pid.shape[0]
    pos = torch.arange(cap, device=seg.pid.device)
    fs, fe = frame.start, frame.end
    if frame.mode == "rows":
        flo = seg.pstart if fs == "u" else pos if fs == "c" else \
            torch.maximum(seg.pstart, pos + int(fs))
        fhi = seg.part_end if fe == "u" else pos if fe == "c" else \
            torch.minimum(seg.part_end, pos + int(fe))
        return flo, fhi
    sv0, ok0 = canonical_order(order, cap, seg.pid.device)
    if fs == "u":
        flo = seg.pstart
    elif fs == "c":
        flo = seg.peer_start
    else:
        flo = _part_searchsorted(sv0, sv0 + _range_offset(order, fs),
                                 seg.pstart, seg.part_end, True)
        flo = torch.where(ok0, flo, seg.peer_start)
    if fe == "u":
        fhi = seg.part_end
    elif fe == "c":
        fhi = seg.peer_end
    else:
        fhi = _part_searchsorted(sv0, sv0 + _range_offset(order, fe),
                                 seg.pstart, seg.part_end, False) - 1
        fhi = torch.where(ok0, fhi, seg.peer_end)
    return flo, fhi


def range_sum(arr: torch.Tensor, flo: torch.Tensor,
              fhi: torch.Tensor) -> torch.Tensor:
    """Framed sum as a prefix-sum difference (integers wrap)."""
    cap = arr.shape[0]
    pre = torch.cumsum(arr, 0)
    hi_v = pre[torch.clamp(fhi, 0, cap - 1)]
    lo_v = torch.where(flo > 0, pre[torch.clamp(flo - 1, 0, cap - 1)],
                       torch.zeros((), dtype=pre.dtype))
    return torch.where(fhi >= flo, hi_v - lo_v,
                       torch.zeros((), dtype=pre.dtype))


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def dd_prefix(arr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive double-double prefix sums (hi, lo) of `arr`: a
    log-step (Hillis-Steele) scan of the two-sum combine (torch has no
    associative_scan)."""
    hi = arr.clone()
    lo = torch.zeros_like(arr)
    n = arr.shape[0]
    shift = 1
    while shift < n:
        s, e = _two_sum(hi[:-shift], hi[shift:])
        e = e + lo[:-shift] + lo[shift:]
        hi = torch.cat([hi[:shift], s])
        lo = torch.cat([lo[:shift], e])
        shift <<= 1
    return hi, lo


def range_sum_dd(arr: torch.Tensor, flo: torch.Tensor,
                 fhi: torch.Tensor) -> torch.Tensor:
    """Compensated framed float sum: the prefix kept as double-double
    pairs, so a huge early value does not destroy a later frame."""
    cap = arr.shape[0]
    hi, lo = dd_prefix(arr)
    at_hi = torch.clamp(fhi, 0, cap - 1)
    at_lo = torch.clamp(flo - 1, 0, cap - 1)
    zero = torch.zeros((), dtype=arr.dtype)
    hi_l = torch.where(flo > 0, hi[at_lo], zero)
    lo_l = torch.where(flo > 0, lo[at_lo], zero)
    v = (hi[at_hi] - hi_l) + (lo[at_hi] - lo_l)
    return torch.where(fhi >= flo, v, zero)


def float_range_sum(arr: torch.Tensor, w: torch.Tensor,
                    flo: torch.Tensor, fhi: torch.Tensor) -> torch.Tensor:
    """Float framed sum with exact IEEE special values: the finite part
    through the compensated prefix, NaN / +Inf / -Inf counted with
    integer prefix sums and applied only to frames holding them."""
    finite = torch.isfinite(arr)
    base = range_sum_dd(torch.where(finite, arr, 0.0), flo, fhi)
    n_nan = range_sum((w & torch.isnan(arr)).to(torch.int64), flo, fhi)
    n_pinf = range_sum((w & (arr == math.inf)).to(torch.int64), flo, fhi)
    n_ninf = range_sum((w & (arr == -math.inf)).to(torch.int64), flo, fhi)
    out = torch.where(n_pinf > 0, math.inf, base)
    out = torch.where(n_ninf > 0, -math.inf, out)
    out = torch.where((n_pinf > 0) & (n_ninf > 0), math.nan, out)
    return torch.where(n_nan > 0, math.nan, out)


def _weights(svalid: torch.Tensor, vals: Optional[CVal],
             filt: Optional[CVal]) -> torch.Tensor:
    w = svalid if vals is None else svalid & vals[1]
    if filt is not None:
        w = w & filt[0].to(torch.bool) & filt[1]
    return w


def frame_sum_plain(seg: Segments, order: Optional[OrderKey], fn: str,
                    vals: Optional[CVal], filt: Optional[CVal],
                    svalid: torch.Tensor, frame: Frame,
                    out_dtype: torch.dtype) -> CVal:
    """Plain version of K14: framed count / sum / avg of the rows that
    contribute (live, argument not NULL, FILTER true), in sorted order.
    count: int64 masked by svalid; sum: `out_dtype` (int64 wrapping or
    float64) masked where the frame holds a contribution; avg: float64
    likewise."""
    flo, fhi = frame_plain(seg, order, frame)
    w = _weights(svalid, vals, filt)
    runc = range_sum(w.to(torch.int64), flo, fhi)
    if fn == "count":
        return runc, svalid
    floating = fn == "avg" or out_dtype.is_floating_point
    dt = torch.float64 if floating else out_dtype
    contrib = torch.where(w, vals[0].to(dt), torch.zeros((), dtype=dt))
    run = float_range_sum(contrib, w, flo, fhi) if floating \
        else range_sum(contrib, flo, fhi)
    if fn == "avg":
        run = run / torch.clamp(runc, min=1)
    return run.to(out_dtype), (runc > 0) & svalid


def _minmax_ident(fn: str, dtype: torch.dtype):
    info = torch.finfo(dtype) if dtype.is_floating_point \
        else torch.iinfo(dtype)
    return info.max if fn == "min" else info.min


def _rmq(contrib: torch.Tensor, flo: torch.Tensor, fhi: torch.Tensor,
         op, ident) -> torch.Tensor:
    """Range min/max over [flo, fhi] per row through a sparse table of
    ceil(log2 n) + 1 doubling levels (the reference's `_rmq`)."""
    n = contrib.shape[0]
    levels = max(1, math.ceil(math.log2(max(n, 2))) + 1)
    tabs = [contrib]
    for lv in range(1, levels):
        shift = 1 << (lv - 1)
        prev = tabs[-1]
        fill = torch.full((min(shift, n),), ident, dtype=prev.dtype,
                          device=prev.device)
        shifted = torch.cat([prev[shift:], fill]) if shift < n else fill
        tabs.append(op(prev, shifted))
    table = torch.stack(tabs).reshape(-1)
    w = fhi - flo + 1
    k = torch.where(w > 0, torch.floor(torch.log2(
        torch.clamp(w, min=1).to(torch.float64))), 0).to(torch.int64)
    lo = torch.clamp(flo, 0, n - 1)
    hi2 = torch.clamp(fhi - (1 << k) + 1, 0, n - 1)
    res = op(table[k * n + lo], table[k * n + hi2])
    return torch.where(w > 0, res, torch.full_like(res, ident))


def frame_minmax_plain(seg: Segments, order: Optional[OrderKey], fn: str,
                       vals: CVal, filt: Optional[CVal],
                       svalid: torch.Tensor, frame: Frame) -> CVal:
    """Plain version of K15: framed min / max of the contributing rows
    (NaN wins, as jnp.minimum / jnp.maximum), in the argument's dtype,
    masked where the frame holds a contribution."""
    flo, fhi = frame_plain(seg, order, frame)
    w = _weights(svalid, vals, filt)
    runc = range_sum(w.to(torch.int64), flo, fhi)
    data = vals[0]
    if data.dtype == torch.bool:
        data = data.to(torch.int32)
    ident = _minmax_ident(fn, data.dtype)
    contrib = torch.where(w, data, torch.full_like(data, ident))
    op = torch.minimum if fn == "min" else torch.maximum
    run = _rmq(contrib, flo, fhi, op, ident)
    return run.to(vals[0].dtype), (runc > 0) & svalid


@dataclasses.dataclass
class Emit:
    """One output column of K16, in sorted order before the scatter.

    kind: a RANKING or POSITIONAL function name, or "copy" (a column
    K14 / K15 computed). `src` is the positional argument or the copied
    column; `offset` is lag/lead's distance (positive = lag), ntile's
    bucket count or nth_value's N; `default` lag/lead's constant (a
    dictionary code for strings); `out_dtype` the ranking output's."""
    kind: str
    src: Optional[CVal] = None
    offset: int = 1
    frame: Optional[Frame] = None
    default: Any = None
    out_dtype: torch.dtype = torch.int64


def _emit_sorted(e: Emit, seg: Segments, order: Optional[OrderKey],
                 svalid: torch.Tensor) -> CVal:
    cap = svalid.shape[0]
    pos = torch.arange(cap, device=svalid.device)
    psize = seg.part_end - seg.pstart + 1
    if e.kind == "copy":
        return e.src
    if e.kind in RANKING:
        if e.kind == "row_number":
            v = pos - seg.pstart + 1
        elif e.kind == "rank":
            v = seg.peer_start - seg.pstart + 1
        elif e.kind == "dense_rank":
            v = seg.dense - seg.dense[seg.pstart] + 1
        elif e.kind == "ntile":
            # larger buckets first: r = psize % n buckets get q+1 rows
            nt = max(int(e.offset), 1)
            q = psize // nt
            r = psize % nt
            idx = pos - seg.pstart
            cutoff = r * (q + 1)
            v = torch.where(
                idx < cutoff,
                idx // torch.clamp(q + 1, min=1) + 1,
                r + (idx - cutoff) // torch.clamp(q, min=1) + 1)
        elif e.kind == "percent_rank":
            rk = (seg.peer_start - seg.pstart).to(torch.float64)
            v = torch.where(psize > 1,
                            rk / torch.clamp(psize - 1, min=1), 0.0)
        else:  # cume_dist
            v = (seg.peer_end - seg.pstart + 1).to(torch.float64) \
                / torch.clamp(psize, min=1)
        return v.to(e.out_dtype), svalid
    sd, sm = e.src
    if e.kind in ("lag", "lead"):
        k = e.offset if e.kind == "lag" else -e.offset
        idx = torch.clamp(pos - k, 0, cap - 1)
        in_part = (seg.pid[idx] == seg.pid) & svalid[idx] \
            & (pos - k >= 0) & (pos - k <= cap - 1)
        d = sd[idx]
        m = in_part & sm[idx]
        if e.default is not None:
            d = torch.where(in_part, d, torch.full_like(d, e.default))
            m = m | ~in_part
        return d, m & svalid
    flo, fhi = frame_plain(seg, order, e.frame)
    if e.kind == "first_value":
        idx = flo
    elif e.kind == "last_value":
        idx = fhi
    else:  # nth_value: the N-th row of the frame
        idx = flo + (max(int(e.offset), 1) - 1)
    nonempty = (fhi >= flo) & (idx >= flo) & (idx <= fhi)
    idx = torch.clamp(idx, 0, cap - 1)
    return sd[idx], sm[idx] & nonempty & svalid


def emit_plain(seg: Segments, order: Optional[OrderKey],
               svalid: torch.Tensor, iota_sorted: torch.Tensor,
               emits: Sequence[Emit]) -> List[CVal]:
    """Plain version of K16: every output column computed in sorted
    order, then scattered to input order."""
    out = []
    for e in emits:
        d, m = _emit_sorted(e, seg, order, svalid)
        od = torch.empty_like(d)
        om = torch.empty_like(m)
        od[iota_sorted] = d
        om[iota_sorted] = m
        out.append((od, om))
    return out


# -- the CUDA kernels ------------------------------------------------------

#: launches of K13-K16, under the reference's family name
SEGMENTS_KERNEL = _tk.LaunchCounter("window_segments", "window")
FRAME_SUM_KERNEL = _tk.LaunchCounter("window_frame_sum", "window")
FRAME_MINMAX_KERNEL = _tk.LaunchCounter("window_frame_minmax", "window")
EMIT_KERNEL = _tk.LaunchCounter("window_emit", "window")

#: csrc/window_frame.cuh frame-bound kinds
_FB = {"u": 0, "c": 1}
#: most output columns one K16 launch writes (window_emit.cu MAX_EMIT)
EMIT_MAX = 16
_EMIT_KINDS = {"row_number": 0, "rank": 1, "dense_rank": 2, "ntile": 3,
               "percent_rank": 4, "cume_dist": 5, "lag": 6, "lead": 6,
               "first_value": 7, "last_value": 8, "nth_value": 9,
               "copy": 10}
#: K14's function codes
_SUM_FNS = {"count": 0, "sum_int": 1, "sum_float": 2, "avg": 3}
#: K15's value dtypes (csrc/window_frame_minmax.cu VDtype)
_MINMAX_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
                  torch.float64: 3}


class _SegArgs(ctypes.Structure):
    """csrc/window_frame.cuh `WinSeg`."""
    _fields_ = [("pid", ctypes.c_void_p), ("pstart", ctypes.c_void_p),
                ("pend", ctypes.c_void_p), ("peer_start", ctypes.c_void_p),
                ("peer_end", ctypes.c_void_p), ("dense", ctypes.c_void_p),
                ("valid", ctypes.c_void_p), ("n", ctypes.c_int64)]


class _OrderArgs(ctypes.Structure):
    """csrc/window_frame.cuh `WinOrder`."""
    _fields_ = [("data", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("dtype", ctypes.c_int32), ("desc", ctypes.c_int32),
                ("nulls_first", ctypes.c_int32),
                ("present", ctypes.c_int32)]


class _FrameArgs(ctypes.Structure):
    """csrc/window_frame.cuh `WinFrame`."""
    _fields_ = [("range", ctypes.c_int32), ("s_kind", ctypes.c_int32),
                ("e_kind", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("s_off_i", ctypes.c_int64), ("e_off_i", ctypes.c_int64),
                ("s_off_f", ctypes.c_double), ("e_off_f", ctypes.c_double)]


class _EmitArgs(ctypes.Structure):
    """csrc/window_emit.cu `EmitSpec`."""
    _fields_ = [("kind", ctypes.c_int32), ("elem", ctypes.c_int32),
                ("has_default", ctypes.c_int32),
                ("out_float", ctypes.c_int32),
                ("offset", ctypes.c_int64), ("default_bits", ctypes.c_int64),
                ("frame", _FrameArgs),
                ("src", ctypes.c_void_p), ("src_mask", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("out_mask", ctypes.c_void_p)]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _seg_args(seg: Segments, svalid: torch.Tensor) -> _SegArgs:
    n = svalid.shape[0]
    dev = svalid.device
    for name in ("pid", "pstart", "part_end", "peer_start", "peer_end",
                 "dense"):
        common.check_rows(getattr(seg, name), n, dev, (torch.int64,),
                          f"window: segments.{name}")
    common.check_rows(svalid, n, dev, (torch.bool,), "window: valid")
    return _SegArgs(_ptr(seg.pid), _ptr(seg.pstart), _ptr(seg.part_end),
                    _ptr(seg.peer_start), _ptr(seg.peer_end),
                    _ptr(seg.dense), _ptr(svalid), n)


def _order_args(order: Optional[OrderKey], n: int,
                dev: torch.device) -> _OrderArgs:
    if order is None:
        return _OrderArgs(None, None, 0, 0, 0, 0)
    common.check_rows(order.data, n, dev, tuple(common.KEY_DTYPES),
                      "window: order key")
    common.check_rows(order.mask, n, dev, (torch.bool,),
                      "window: order key mask")
    return _OrderArgs(_ptr(order.data), _ptr(order.mask),
                      common.KEY_DTYPES[order.data.dtype],
                      int(order.descending), int(order.nulls_first), 1)


def _frame_args(frame: Optional[Frame],
                order: Optional[OrderKey]) -> _FrameArgs:
    if frame is None:
        return _FrameArgs(0, 0, 0, 0, 0, 0, 0.0, 0.0)
    rng = frame.mode == "range"

    def enc(b):
        if b in _FB:
            return _FB[b], 0, 0.0
        if rng:
            off = _range_offset(order, b)
            return 2, int(off), float(off)
        return 2, int(b), float(b)
    sk, si, sf = enc(frame.start)
    ek, ei, ef = enc(frame.end)
    return _FrameArgs(int(rng), sk, ek, 0, si, ei, sf, ef)


def _segments_cuda(spart, sorder, svalid) -> Segments:
    from presto_tpu_torch.native import cuda
    dev = svalid.device
    n = svalid.shape[0]
    common.check_rows(svalid, n, dev, (torch.bool,), "window_segments: "
                      "valid")
    lib = cuda.library("window_segments")
    stream = ctypes.c_void_p(cuda.stream_ptr(dev))
    flags = torch.zeros(n, dtype=torch.uint8, device=dev)
    # adjacent-key compares, at most MAX_KEYS key columns per launch:
    # bit 0 marks a partition key change, bit 1 an order key change
    for bit, keys in ((1, spart), (2, sorder)):
        keys = [(d.contiguous(), m.contiguous()) for d, m in keys]
        for group in common.key_groups(keys):
            kd, km, kt, nk = common.key_args(group, n, dev,
                                             "window_segments")
            cuda.check(lib, lib.presto_window_key_changes(
                kd, km, kt, nk, ctypes.c_int64(n), ctypes.c_int32(bit),
                ctypes.c_void_p(flags.data_ptr()), stream),
                "window_segments")
    tile = lib.presto_window_tile()
    ntiles = (n + tile - 1) // tile
    out = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(6)]
    scratch = torch.empty(8 * ntiles + 1, dtype=torch.int64, device=dev)
    cuda.check(lib, lib.presto_window_segments(
        ctypes.c_void_p(flags.data_ptr()),
        ctypes.c_void_p(svalid.data_ptr()), ctypes.c_int64(n),
        ctypes.c_int32(int(bool(spart))), ctypes.c_int32(int(bool(sorder))),
        *[ctypes.c_void_p(t.data_ptr()) for t in out],
        ctypes.c_void_p(scratch.data_ptr()), stream), "window_segments")
    SEGMENTS_KERNEL.launches += 1
    return Segments(*out)


def window_segments(spart: Sequence[CVal], sorder: Sequence[CVal],
                    svalid: torch.Tensor) -> Segments:
    """K13 over rows sorted by (partition keys, order keys), valid rows
    first. The CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if svalid.device.type == "cpu":
        return segments_plain(spart, sorder, svalid)
    return _segments_cuda(spart, sorder, svalid)


def _opt_col(col: Optional[CVal], n: int, dev, dtypes, what: str):
    if col is None:
        return None, None, 0
    common.check_rows(col[0], n, dev, dtypes, f"{what} data")
    common.check_rows(col[1], n, dev, (torch.bool,), f"{what} mask")
    return col[0].data_ptr(), col[1].data_ptr(), \
        common.KEY_DTYPES.get(col[0].dtype, 0)


def _frame_sum_cuda(seg, order, fn, vals, filt, svalid, frame, out_dtype):
    from presto_tpu_torch.native import cuda
    dev = svalid.device
    n = svalid.shape[0]
    sa = _seg_args(seg, svalid)
    oa = _order_args(order, n, dev)
    if fn == "count":
        code = _SUM_FNS["count"]
    elif fn == "avg" or out_dtype.is_floating_point:
        code = _SUM_FNS["avg" if fn == "avg" else "sum_float"]
    else:
        code = _SUM_FNS["sum_int"]
    if fn != "count" and out_dtype not in (torch.int64, torch.float64):
        raise ValueError(f"window_frame_sum: {fn} into {out_dtype}")
    vd, vm, vt = _opt_col(vals, n, dev, tuple(common.KEY_DTYPES),
                          "window_frame_sum: argument")
    fd, fm, _ = _opt_col(filt, n, dev, (torch.bool,),
                         "window_frame_sum: filter")
    lib = cuda.library("window_frame_sum")
    tile = lib.presto_window_tile()
    ntiles = (n + tile - 1) // tile
    floating = code >= 2
    # inclusive prefixes: count (+ int sum | dd hi, dd lo, NaN, +Inf,
    # -Inf), then the per-tile offsets of each
    planes = 6 if floating else 2
    pre = torch.empty(planes * (n + ntiles), dtype=torch.int64,
                      device=dev)
    out = torch.empty(n, dtype=torch.int64 if code < 2 else torch.float64,
                      device=dev)
    mask = torch.empty(n, dtype=torch.bool, device=dev)
    cuda.check(lib, lib.presto_window_frame_sum(
        ctypes.byref(sa), ctypes.byref(oa),
        ctypes.byref(_frame_args(frame, order)), ctypes.c_int32(code),
        ctypes.c_void_p(vd), ctypes.c_void_p(vm), ctypes.c_int32(vt),
        ctypes.c_void_p(fd), ctypes.c_void_p(fm),
        ctypes.c_void_p(pre.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(mask.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev))), "window_frame_sum")
    FRAME_SUM_KERNEL.launches += 1
    return out, mask


def window_frame_sum(seg: Segments, order: Optional[OrderKey], fn: str,
                     vals: Optional[CVal], filt: Optional[CVal],
                     svalid: torch.Tensor, frame: Frame,
                     out_dtype: torch.dtype) -> CVal:
    """K14 (see `frame_sum_plain`). The CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if svalid.device.type == "cpu":
        return frame_sum_plain(seg, order, fn, vals, filt, svalid, frame,
                               out_dtype)
    return _frame_sum_cuda(seg, order, fn, vals, filt, svalid, frame,
                           out_dtype)


#: rows per leaf of K15's blocked sparse table (MINMAX_LEAF)
MINMAX_LEAF = 32


def minmax_table_levels(n: int) -> Tuple[int, int]:
    """(leaves, levels) of K15's sparse table over n rows."""
    leaves = max((n + MINMAX_LEAF - 1) // MINMAX_LEAF, 1)
    return leaves, max(1, math.ceil(math.log2(max(leaves, 2))) + 1)


def _frame_minmax_cuda(seg, order, fn, vals, filt, svalid, frame):
    from presto_tpu_torch.native import cuda
    dev = svalid.device
    n = svalid.shape[0]
    sa = _seg_args(seg, svalid)
    oa = _order_args(order, n, dev)
    data = vals[0]
    widen = data.dtype not in _MINMAX_DTYPES
    if widen:  # bool / int8 / int16 compare exactly as int32
        data = data.to(torch.int32)
    vd, vm, _ = _opt_col((data.contiguous(), vals[1].contiguous()), n,
                         dev, tuple(_MINMAX_DTYPES),
                         "window_frame_minmax: argument")
    fd, fm, _ = _opt_col(filt, n, dev, (torch.bool,),
                         "window_frame_minmax: filter")
    leaves, levels = minmax_table_levels(n)
    table = torch.empty(leaves * levels, dtype=data.dtype, device=dev)
    any_tab = torch.empty(leaves * levels, dtype=torch.uint8, device=dev)
    out = torch.empty(n, dtype=data.dtype, device=dev)
    mask = torch.empty(n, dtype=torch.bool, device=dev)
    lib = cuda.library("window_frame_minmax")
    cuda.check(lib, lib.presto_window_frame_minmax(
        ctypes.byref(sa), ctypes.byref(oa),
        ctypes.byref(_frame_args(frame, order)),
        ctypes.c_int32(int(fn == "max")),
        ctypes.c_int32(_MINMAX_DTYPES[data.dtype]),
        ctypes.c_void_p(vd), ctypes.c_void_p(vm),
        ctypes.c_void_p(fd), ctypes.c_void_p(fm),
        ctypes.c_void_p(table.data_ptr()),
        ctypes.c_void_p(any_tab.data_ptr()), ctypes.c_int64(leaves),
        ctypes.c_int32(levels), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(mask.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev))), "window_frame_minmax")
    FRAME_MINMAX_KERNEL.launches += 1
    return (out.to(vals[0].dtype) if widen else out), mask


def window_frame_minmax(seg: Segments, order: Optional[OrderKey],
                        fn: str, vals: CVal, filt: Optional[CVal],
                        svalid: torch.Tensor, frame: Frame) -> CVal:
    """K15 (see `frame_minmax_plain`). The CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if svalid.device.type == "cpu":
        return frame_minmax_plain(seg, order, fn, vals, filt, svalid,
                                  frame)
    return _frame_minmax_cuda(seg, order, fn, vals, filt, svalid, frame)


def _default_bits(value, dtype: torch.dtype) -> int:
    """lag/lead's default as the int64 whose low bytes hold it in the
    argument's dtype."""
    raw = np.array([value]).astype(
        torch.empty((), dtype=dtype).numpy().dtype).tobytes()
    return struct.unpack("<q", raw.ljust(8, b"\0"))[0]


def emit_chunks(n: int) -> List[Tuple[int, int]]:
    """The [lo, hi) ranges of output columns K16's launches take, at
    most EMIT_MAX each."""
    return [(lo, min(lo + EMIT_MAX, n)) for lo in range(0, n, EMIT_MAX)]


def _emit_cuda(seg, order, svalid, iota_sorted, emits):
    from presto_tpu_torch.native import cuda
    dev = svalid.device
    n = svalid.shape[0]
    sa = _seg_args(seg, svalid)
    oa = _order_args(order, n, dev)
    common.check_rows(iota_sorted, n, dev, (torch.int64,),
                      "window_emit: iota")
    outs, specs = [], []
    for e in emits:
        if e.kind in RANKING:
            d = torch.empty(n, dtype=e.out_dtype, device=dev)
            if e.out_dtype not in (torch.int64, torch.float64):
                raise ValueError(f"window_emit: {e.kind} into "
                                 f"{e.out_dtype}")
            src, src_m, elem = None, None, 8
        else:
            sd, sm = e.src
            common.check_rows(sd, n, dev, (sd.dtype,), "window_emit: "
                              "source")
            common.check_rows(sm, n, dev, (torch.bool,),
                              "window_emit: source mask")
            if sd.element_size() not in common.GATHER_ELEM_SIZES:
                raise ValueError(f"window_emit: {sd.element_size()}-byte "
                                 "elements")
            d = torch.empty_like(sd)
            src, src_m, elem = sd.data_ptr(), sm.data_ptr(), \
                sd.element_size()
        m = torch.empty(n, dtype=torch.bool, device=dev)
        outs.append((d, m))
        has_default = e.kind in ("lag", "lead") and e.default is not None
        offset = -e.offset if e.kind == "lead" else e.offset
        specs.append(_EmitArgs(
            _EMIT_KINDS[e.kind], elem, int(has_default),
            int(e.kind in RANKING and e.out_dtype == torch.float64),
            int(offset),
            _default_bits(e.default, d.dtype) if has_default else 0,
            _frame_args(e.frame, order), src, src_m, d.data_ptr(),
            m.data_ptr()))
    lib = cuda.library("window_emit")
    for lo, hi in emit_chunks(len(specs)):
        arr = (_EmitArgs * (hi - lo))(*specs[lo:hi])
        cuda.check(lib, lib.presto_window_emit(
            ctypes.byref(sa), ctypes.byref(oa),
            ctypes.c_void_p(iota_sorted.data_ptr()), arr,
            ctypes.c_int32(hi - lo), ctypes.c_void_p(cuda.stream_ptr(dev))),
            "window_emit")
        EMIT_KERNEL.launches += 1
    return outs


def window_emit(seg: Segments, order: Optional[OrderKey],
                svalid: torch.Tensor, iota_sorted: torch.Tensor,
                emits: Sequence[Emit]) -> List[CVal]:
    """K16 (see `emit_plain`). The CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if svalid.device.type == "cpu":
        return emit_plain(seg, order, svalid, iota_sorted, emits)
    return _emit_cuda(seg, order, svalid, iota_sorted, emits)


# -- the whole-relation window pass ---------------------------------------


def window_kernel(batch: Batch, part_names: Tuple[str, ...],
                  order_names: Tuple[str, ...],
                  descending: Tuple[bool, ...],
                  nulls_first: Tuple[bool, ...],
                  calls: Tuple[WindowCallSpec, ...]) -> Batch:
    """Every call of one OVER() spec over one whole relation; the input
    columns in input order plus one column per call (the reference's
    `_window_kernel_jit`)."""
    _tk.count("window")
    cap = batch.capacity
    dev = batch.device
    part_cols = [batch.columns[n].astuple() for n in part_names]
    order_cols = [batch.columns[n].astuple() for n in order_names]
    ref_args = tuple(sorted(
        {c.arg for c in calls if c.arg is not None}
        | {c.filter_arg for c in calls if c.filter_arg is not None}))
    payloads: List[torch.Tensor] = []
    for a in ref_args:
        payloads.extend(batch.columns[a].astuple())
    payloads.append(torch.arange(cap, device=dev))
    skeys, svalid, spay = common.sort_rows(
        part_cols + order_cols,
        descending=(False,) * len(part_cols) + tuple(descending),
        nulls_first=(False,) * len(part_cols) + tuple(nulls_first),
        valid=batch.row_valid, payloads=payloads)
    skeys = [(d.contiguous(), m.contiguous()) for d, m in skeys]
    spart, sorder = skeys[:len(part_cols)], skeys[len(part_cols):]
    sargs = {a: (spay[2 * i].contiguous(), spay[2 * i + 1].contiguous())
             for i, a in enumerate(ref_args)}
    iota_sorted = spay[-1].contiguous()
    svalid = svalid.contiguous()
    seg = window_segments(spart, sorder, svalid)
    order = OrderKey(sorder[0][0], sorder[0][1], bool(descending[0]),
                     bool(nulls_first[0])) if sorder else None

    emits: List[Emit] = []
    for c in calls:
        frame = Frame(*c.norm_frame())
        if c.function in RANKING:
            emits.append(Emit(c.function, offset=int(c.offset or 1),
                              out_dtype=c.out_type.torch_dtype))
            continue
        if c.function in POSITIONAL:
            emits.append(Emit(c.function, sargs[c.arg],
                              offset=int(c.offset), frame=frame,
                              default=c.default))
            continue
        vals = None if c.arg is None else sargs[c.arg]
        filt = None if c.filter_arg is None else sargs[c.filter_arg]
        if c.function in ("count", "sum", "avg"):
            res = window_frame_sum(seg, order, c.function, vals, filt,
                                   svalid, frame, c.out_type.torch_dtype)
        elif c.function in ("min", "max"):
            res = window_frame_minmax(seg, order, c.function, vals, filt,
                                      svalid, frame)
        else:
            raise ValueError(f"unknown window function {c.function}")
        emits.append(Emit("copy", res))
    outs = window_emit(seg, order, svalid, iota_sorted, emits)
    cols: Dict[str, Column] = dict(batch.columns)
    for c, (d, m) in zip(calls, outs):
        dic = None if c.function in RANKING else c.out_dict
        cols[c.out_name] = Column(d, m, c.out_type, dic)
    return Batch(cols, batch.row_valid)
