"""Windows + aggregations + group-by/having, compiled to batched torch ops.

The torch port of ``flink_siddhi_tpu/compiler/window.py``. Siddhi sliding
windows emit one aggregated row per *arriving* event over the events the
window currently holds (``#window.length(n)``, ``#window.time(t)``,
``timeLength``, ``externalTime``); batch windows (``lengthBatch``,
``timeBatch``, ``externalTimeBatch``, ``cron``) emit per-group rows when a
window tumbles; aggregation with no window is cumulative from the stream's
start; ``insert expired events`` (and ``#window.delay``) emits events as they
leave a window. Each shape is one data-parallel step over a micro-batch:

* sliding windows carry a ring of the last C matching events. The common
  case (count/sum/avg/stddev over length or time windows, min/max over
  length windows, group-by on host-interned codes) takes the sort path
  (``_step_blocked``): a stable sort of ring + arrivals by group code,
  and a window sum is the sum of the group's entries that have arrived,
  less those that have left, each a within-group prefix sum (integers
  exact in int64, floats through a log-depth segmented scan in float64). The reference builds the same sums from
  one-hot and lower-triangular matmuls, because sorts are slow on a TPU;
  on the GPU a radix sort is cheap and the matmuls' one-hot traffic is
  not. Every other case builds the ``[E, C]`` window of each event
  (``_step_matrix``) and reduces it, as the reference does.
* cumulative aggregation: a per-group state table, a stable segment sort,
  compensated (Neumaier) running float sums, segmented min/max.
* batch windows: events map to a (window slot, group) grid, reduced in a
  fixed order; completed cells flush to a buffer, the incomplete window is
  the carry.

Everything runs without a host wait: device-side counts index through
gathers (``M + arange(C)``), never through Python ints. The product of the
reference's ``associative_scan`` is a doubling scan (``_seg_scan``), a
fixed sequence of whole-array ops.

Inside ``partition with`` a length window is ``PerKeyWindowArtifact``
(each key's own last C events: per-key prefix differences, a ring of
prefix checkpoints), a time window the shared time window grouped by the
key; a sort or session window goes to ``scan_windows.py`` (a buffer a
partition, a session a key), a unique window raises naming ROADMAP.md
Queue 1 item 8; any other window raises the reference's message. The
scan windows (``#window.sort``, ``unique``, ``session``, ``frequent``,
``lossyFrequent``) are ``scan_windows.py``'s, each one kernel call a
micro-batch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import torch_dtype
from ..query import ast
from ..query.lexer import SiddhiQLError
from ..runtime.tape import EncodedColumn, HostPred, bucket_size
from ..schema.encoders import GroupEncoder
from ..schema.types import AttributeType
from .expr import (
    ColumnEnv,
    ExprResolver,
    ResolvedAttr,
    as_column,
    compile_expr,
)
from .output import ColumnBatch, OutputField, OutputSchema, emission_order

MIN_GROUP_CAPACITY = 64
_I32 = torch.int32
_I64 = torch.int64
_I32_MIN = -(2 ** 31)
_I32_MAX = 2 ** 31 - 1
_NEG = -(2 ** 31) + 1  # the reference's "no event" marker in max grids

# --------------------------------------------------------------------------
# Aggregate extraction / expression rewriting
# --------------------------------------------------------------------------

_SUMLIKE_TYPES = {
    AttributeType.INT: AttributeType.LONG,
    AttributeType.LONG: AttributeType.LONG,
    AttributeType.FLOAT: AttributeType.DOUBLE,
    AttributeType.DOUBLE: AttributeType.DOUBLE,
}


@dataclass
class _Agg:
    kind: str  # sum count avg min max stddev distinctcount
    arg_idx: int  # index into distinct arg expressions; -1 = none (count())
    out_type: AttributeType
    slot: str  # env key "@aggN"


class _AggCollector:
    """Dedups aggregate calls and their argument expressions."""

    def __init__(self, resolver: ExprResolver, extensions) -> None:
        self.resolver = resolver
        self.extensions = extensions
        self.aggs: List[_Agg] = []
        self.arg_fns: List[Callable] = []
        self.arg_types: List[AttributeType] = []
        self._agg_keys: Dict[str, int] = {}
        self._arg_keys: Dict[str, int] = {}

    def _arg_index(self, expr: ast.Expr) -> Tuple[int, AttributeType]:
        key = repr(expr)
        if key in self._arg_keys:
            i = self._arg_keys[key]
            return i, self.arg_types[i]
        ce = compile_expr(expr, self.resolver, self.extensions)
        if not ce.atype.is_numeric and ce.atype != AttributeType.STRING:
            raise SiddhiQLError(
                f"cannot aggregate over type {ce.atype.value}"
            )
        i = len(self.arg_fns)
        self._arg_keys[key] = i
        self.arg_fns.append(ce.fn)
        self.arg_types.append(ce.atype)
        return i, ce.atype

    def intern(self, call: ast.Call) -> _Agg:
        key = repr(call)
        if key in self._agg_keys:
            return self.aggs[self._agg_keys[key]]
        kind = call.name.lower()
        if kind == "count":
            if len(call.args) > 1:
                raise SiddhiQLError("count() takes at most one argument")
            arg_idx, out_type = -1, AttributeType.LONG
        else:
            if len(call.args) != 1:
                raise SiddhiQLError(f"{kind}() takes exactly one argument")
            arg_idx, arg_type = self._arg_index(call.args[0])
            if kind == "sum":
                if arg_type not in _SUMLIKE_TYPES:
                    raise SiddhiQLError("sum() needs a numeric argument")
                out_type = _SUMLIKE_TYPES[arg_type]
            elif kind in ("avg", "stddev"):
                if not arg_type.is_numeric:
                    raise SiddhiQLError(f"{kind}() needs a numeric argument")
                out_type = AttributeType.DOUBLE
            elif kind in ("min", "max"):
                if not arg_type.is_numeric:
                    raise SiddhiQLError(f"{kind}() needs a numeric argument")
                out_type = arg_type
            elif kind == "distinctcount":
                out_type = AttributeType.LONG
            else:
                raise SiddhiQLError(f"unknown aggregation {call.name!r}")
        agg = _Agg(kind, arg_idx, out_type, f"@agg{len(self.aggs)}")
        self._agg_keys[key] = len(self.aggs)
        self.aggs.append(agg)
        return agg

    def rewrite(self, expr: ast.Expr) -> ast.Expr:
        """Replace aggregate calls with slot references."""
        if ast.is_aggregate_call(expr):
            return ast.Attr(self.intern(expr).slot)
        if isinstance(expr, ast.Unary):
            return ast.Unary(expr.op, self.rewrite(expr.operand))
        if isinstance(expr, ast.Binary):
            return ast.Binary(
                expr.op, self.rewrite(expr.left), self.rewrite(expr.right)
            )
        if isinstance(expr, ast.Call):
            return ast.Call(
                expr.name,
                tuple(self.rewrite(a) for a in expr.args),
                expr.namespace,
            )
        return expr


class _SlotResolver:
    """Resolver layering synthetic env slots (@aggN, select aliases) over the
    stream resolver."""

    def __init__(self, base, slots: Dict[str, AttributeType]) -> None:
        self._base = base
        self._slots = dict(slots)

    def resolve(self, attr: ast.Attr) -> ResolvedAttr:
        if attr.qualifier is None and attr.index is None:
            if attr.name in self._slots:
                return ResolvedAttr(attr.name, self._slots[attr.name], None)
        return self._base.resolve(attr)


def _referenced_keys(
    expr: ast.Expr, resolver, out: Dict[str, AttributeType]
) -> None:
    """Collect tape column keys a rewritten expression reads (skips slots)."""
    if isinstance(expr, ast.Attr):
        if not expr.name.startswith("@"):
            r = resolver.resolve(expr)
            out[r.key] = r.atype
        return
    if isinstance(expr, ast.Unary):
        _referenced_keys(expr.operand, resolver, out)
    elif isinstance(expr, ast.Binary):
        _referenced_keys(expr.left, resolver, out)
        _referenced_keys(expr.right, resolver, out)
    elif isinstance(expr, ast.Call):
        for a in expr.args:
            _referenced_keys(a, resolver, out)


# --------------------------------------------------------------------------
# Shared reduction helpers
# --------------------------------------------------------------------------

def _dt(atype: AttributeType) -> torch.dtype:
    return torch_dtype(atype.device_dtype)


def _identity(kind: str, dtype: torch.dtype):
    """The identity of ``kind`` in ``dtype`` (a Python scalar): an empty
    min reads +inf or INT_MAX, an empty max -inf or INT_MIN, as in JAX."""
    if kind in ("min", "max"):
        if dtype.is_floating_point:
            return float("inf") if kind == "min" else float("-inf")
        info = torch.iinfo(dtype)
        return info.max if kind == "min" else info.min
    return 0


def _col(flags: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row flag broadcast against ``like`` ([n] or [n, K])."""
    return flags if like.dim() == 1 else flags.unsqueeze(-1)


def _seg_scan(flags, vals, combine):
    """Inclusive segmented scan: runs restart where ``flags`` is True.

    A doubling (Hillis-Steele) scan of the segmented operator
    ``(fa, va) + (fb, vb) = (fa | fb, vb if fb else combine(va, vb))``:
    ceil(log2 n) rounds of whole-array ops (19 at n = 524,288), never a
    loop over events. ``vals`` is ``[n]`` or ``[n, K]``."""
    n = int(vals.shape[0])
    f, v = flags, vals
    d = 1
    while d < n:
        fb = f[d:]
        nv = torch.where(_col(fb, v), v[d:], combine(v[:-d], v[d:]))
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], f[:-d] | fb])
        d *= 2
    return v


def _seg_scan_sum_kahan(flags, vals):
    """Compensated inclusive segmented SUM scan: each element carries a
    (sum, err) pair combined with Neumaier two-sum, so a float32 prefix
    over a long run keeps about float64 accuracy instead of losing every
    addend below the running magnitude's rounding grain. Returns (sum,
    err); the corrected prefix is their sum. Same doubling scan as
    ``_seg_scan``."""
    n = int(vals.shape[0])
    f, s, c = flags, vals, torch.zeros_like(vals)
    d = 1
    while d < n:
        fb = f[d:]
        sa, ca, sb, cb = s[:-d], c[:-d], s[d:], c[d:]
        t = sa + sb
        err = torch.where(
            sa.abs() >= sb.abs(), (sa - t) + sb, (sb - t) + sa
        )
        fbc = _col(fb, s)
        ns = torch.where(fbc, sb, t)
        nc = torch.where(fbc, cb, ca + cb + err)
        s = torch.cat([s[:d], ns])
        c = torch.cat([c[:d], nc])
        f = torch.cat([f[:d], f[:-d] | fb])
        d *= 2
    return s, c


def _inverse(order: torch.Tensor) -> torch.Tensor:
    """The inverse of a permutation (``argsort(order)``)."""
    inv = torch.empty_like(order)
    inv.scatter_(0, order, torch.arange(order.shape[0], device=order.device))
    return inv


def _segment_reduce(vals, seg, nseg: int, kind: str):
    """``jax.ops.segment_{sum,min,max}`` over segments ``[0, nseg)``; a
    segment id of ``nseg`` is a dump slot, sliced off. Integer sums add
    exactly (any order); float sums run in a fixed order — a stable sort
    by segment and a float64 segmented scan, read at each segment's end —
    so that a float total does not change from run to run as atomics
    would make it. An empty segment reads the identity."""
    dev = vals.device
    if kind in ("min", "max"):
        out = torch.full((nseg + 1,), _identity(kind, vals.dtype),
                         dtype=vals.dtype, device=dev)
        return out.scatter_reduce_(
            0, seg, vals, "amin" if kind == "min" else "amax"
        )[:nseg]
    if not vals.dtype.is_floating_point:
        out = torch.zeros(nseg + 1, dtype=vals.dtype, device=dev)
        return out.index_add_(0, seg, vals)[:nseg]
    seg_s, order = torch.sort(seg, stable=True)
    flags = torch.ones_like(seg_s, dtype=torch.bool)
    flags[1:] = seg_s[1:] != seg_s[:-1]
    run = _seg_scan(flags, vals[order].to(torch.float64), torch.add)
    ends = torch.ones_like(flags)
    ends[:-1] = flags[1:]
    out = torch.zeros(nseg + 1, dtype=torch.float64, device=dev)
    out.index_put_((torch.where(ends, seg_s, nseg),),
                   torch.where(ends, run, 0.0))
    return out[:nseg].to(vals.dtype)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d device index, without a host read (indexing a
    tensor with a 0-d tensor converts it to a Python int)."""
    return x.index_select(0, i.reshape(1).long())[0]


def _acc_stats_for(aggs: Sequence[_Agg]) -> Dict[int, set]:
    """arg_idx -> set of accumulator stats needed ('sum','sumsq','min','max')."""
    need: Dict[int, set] = {}
    for a in aggs:
        if a.arg_idx < 0:
            continue
        s = need.setdefault(a.arg_idx, set())
        if a.kind in ("sum", "avg"):
            s.add("sum")
        elif a.kind == "stddev":
            s.update(("sum", "sumsq"))
        elif a.kind in ("min", "max"):
            s.add(a.kind)
        elif a.kind == "distinctcount":
            raise SiddhiQLError(
                "distinctCount() requires a sliding window "
                "(#window.length/#window.time)"
            )
    return need


def _stat_tables(stats: Dict[int, set], arg_types, G: int, device,
                 compensated: bool) -> Dict[str, torch.Tensor]:
    """The per-group accumulators of ``stats``: sums in float32 (int32 for
    integer arguments), each float sum with its Neumaier compensation
    ``kc_*`` when ``compensated``; min/max at their identity."""
    st = {}
    for arg_idx, kinds in stats.items():
        dt = _dt(arg_types[arg_idx])
        for s in kinds:
            if s in ("sum", "sumsq"):
                adt = (torch.float32
                       if dt.is_floating_point or s == "sumsq" else _I32)
                st[f"{s}{arg_idx}"] = torch.zeros(G, dtype=adt,
                                                  device=device)
                if compensated and adt == torch.float32:
                    st[f"kc_{s}{arg_idx}"] = torch.zeros(
                        G, dtype=adt, device=device
                    )
            else:
                st[f"{s}{arg_idx}"] = torch.full(
                    (G,), _identity(s, dt), dtype=dt, device=device
                )
    return st


def _pad_groups(state: Dict, need: int) -> Dict:
    """Every per-group table of ``state`` padded to ``need`` groups: min
    and max tables with their identity, the rest with zeros (scalars and
    the ``enabled`` flag as they are)."""
    out = dict(state)
    for k, v in state.items():
        if v.dim() == 0 or k.startswith("@g"):
            continue  # the chained group tables are rebuilt, not padded
        fill = (_identity(k[:3], v.dtype) if k.startswith(("min", "max"))
                else 0)
        pad = torch.full((need - v.shape[0],), fill, dtype=v.dtype,
                         device=v.device)
        out[k] = torch.cat([v, pad])
    return out


def _agg_from_stats(agg: _Agg, stats: Dict[str, torch.Tensor]):
    cnt = stats["cnt"]
    if agg.kind == "count":
        return cnt
    if agg.kind == "sum":
        return stats[f"sum{agg.arg_idx}"]
    if agg.kind in ("min", "max"):
        return stats[f"{agg.kind}{agg.arg_idx}"]
    safe_cnt = torch.clamp(cnt, min=1)
    mean = stats[f"sum{agg.arg_idx}"].to(torch.float32) / safe_cnt
    if agg.kind == "avg":
        return mean
    if agg.kind == "stddev":
        m2 = stats[f"sumsq{agg.arg_idx}"].to(torch.float32) / safe_cnt
        return torch.sqrt(torch.clamp(m2 - mean * mean, min=0.0))
    raise AssertionError(agg.kind)


def _bucket(n: int, minimum: int) -> int:
    b = minimum
    while b < max(n, 1):
        b *= 2
    return b


def _query_mask(art, state: Dict, tape, env: ColumnEnv) -> torch.Tensor:
    """The events of the artifact's stream its filters accept (and none
    while the query is disabled)."""
    mask = tape.valid & (tape.stream == art.stream_code)
    for f in art.filter_fns:
        mask = mask & f(env)
    return mask & state["enabled"]


def _project(art, env: ColumnEnv, width: int, like, out_mask):
    """The projected columns over ``env`` and the emission mask after
    ``having`` (which may read the select aliases as ``@out:<name>``)."""
    cols = tuple(as_column(p(env), width, like) for p in art.proj_fns)
    if art.having_fn is not None:
        henv = dict(env)
        for f, c in zip(art.output_schema.fields, cols):
            henv[f"@out:{f.name}"] = c
        out_mask = out_mask & art.having_fn(henv)
    return cols, out_mask


# --------------------------------------------------------------------------
# Sliding windows (length / time / timeLength / externalTime)
# --------------------------------------------------------------------------

@dataclass
class SlidingWindowArtifact:
    name: str
    output_schema: OutputSchema
    stream_code: int
    filter_fns: List
    window_mode: str  # 'length' | 'time' | 'timeLength'
    capacity: int  # ring slots C (== W for length windows)
    time_ms: Optional[int]  # window span for 'time'
    ts_key: Optional[str]  # externalTime attribute column; None -> tape ts
    aggs: List[_Agg]
    arg_fns: List[Callable]
    arg_types: List[AttributeType]
    group_fns: List[Callable]
    group_dtypes: List
    proj_fns: List
    having_fn: Optional[Callable]
    output_mode: str = "aligned"
    # dense group codes (host-interned): the sort path orders the window
    # entries by them
    code_key: Optional[str] = None
    encoder: Optional[GroupEncoder] = None
    # wire-opt metadata (window_wire_opts): per select item, the tape key
    # when it is a plain attribute reference; every key it reads; and —
    # once activated — the GROUP-KEY INDEX whose code the item emits
    # instead of the raw column (decode maps codes back through the
    # encoder, so the raw group column never ships)
    proj_srcs: Tuple = ()
    proj_refs: Tuple = ()
    filter_keys: frozenset = frozenset()
    group_keys_: Tuple = ()
    group_code_proj: Tuple = ()

    def cost_info(self) -> Dict:
        """Admission-cost descriptor (analysis/admit.py): one aligned
        row per input event; retention is the ring (length windows
        evict by count, time windows by span)."""
        info = {
            "name": self.name,
            "kind": "window",
            "amplification": 1,
            "residency_ms": (
                int(self.time_ms)
                if self.window_mode == "time" and self.time_ms is not None
                else None
            ),
        }
        if self.encoder is not None:
            info["grows_with"] = "groups"
        return info

    def init_state(self, device) -> Dict:
        C = self.capacity
        ring = {
            "ts": torch.zeros(C, dtype=_I32, device=device),
            "valid": torch.zeros(C, dtype=torch.bool, device=device),
        }
        for j, t in enumerate(self.arg_types):
            ring[f"a{j}"] = torch.zeros(C, dtype=_dt(t), device=device)
        state = {"enabled": torch.tensor(True, device=device), "ring": ring}
        if self._blocked():
            ring["gc"] = torch.zeros(C, dtype=_I32, device=device)
            # the group table's bucket (the reference's one-hot width),
            # re-bucketed by grow_state as the host encoder grows; the
            # sort path reads only the codes
            state["groups"] = torch.zeros(self._gcap(), dtype=_I32,
                                          device=device)
            return state
        for j, dt in enumerate(self.group_dtypes):
            ring[f"g{j}"] = torch.zeros(C, dtype=torch_dtype(dt),
                                        device=device)
        return state

    def _gcap(self) -> int:
        n = len(self.encoder) if self.encoder is not None else 1
        return bucket_size(max(n, 1), minimum=128)

    def grow_state(self, state: Dict) -> Dict:
        if "groups" not in state or state["groups"].shape[0] >= self._gcap():
            return state
        out = dict(state)
        out["groups"] = torch.zeros(self._gcap(), dtype=_I32,
                                    device=state["groups"].device)
        return out

    def _blocked(self) -> bool:
        """Whether the sort path serves this window: count/sum/avg/stddev
        over length windows and event-time windows, and min/max over
        length windows (FIFO expiry makes a window's live members the
        LAST cnt same-group arrivals, a range query). Time windows
        exclude min/max: the cross-batch straggler defence can evict
        early, making the live set non-contiguous. externalTime and
        timeLength keep the matrix path (user timestamps have no
        ordering guarantee), and so does group-by without host codes."""
        if not (
            self.window_mode == "length"
            or (self.window_mode == "time" and self.ts_key is None)
        ):
            return False
        if self.group_fns and self.code_key is None:
            return False
        for a in self.aggs:
            if a.kind in ("min", "max"):
                if self.window_mode != "length":
                    return False
            elif a.kind not in ("count", "sum", "avg", "stddev"):
                return False
        return True

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        if self._blocked():
            return self._step_blocked(state, tape)
        return self._step_matrix(state, tape)

    def _lut(self, c: int, f: OutputField, gi: int) -> List:
        """Decoded group values of output column ``c`` by code: the
        encoder only appends, so the cached list extends instead of
        re-decoding every key per drain."""
        cache = self.__dict__.setdefault("_lut_cache", {})
        lut = cache.setdefault(c, [])
        for i in range(len(lut), len(self.encoder)):
            lut.append(f.decode(self.encoder.value(i)[gi]))
        return lut

    def decode_packed(self, n: int, block: np.ndarray):
        """Group-coded projection columns decode back through the
        encoder (the raw group column never shipped)."""
        schema = self.output_schema
        gcp = self.group_code_proj
        if not gcp or all(g is None for g in gcp):
            return [(schema, schema.decode_packed_block(n, block))]
        order = emission_order(block[0], n)
        ts_list = np.asarray(block[0, :n])[order].astype(np.int64).tolist()
        col_lists = []
        for c, f in enumerate(schema.fields):
            raw = np.asarray(block[1 + c, :n])[order]
            if gcp[c] is not None:
                lut = self._lut(c, f, gcp[c])
                col_lists.append([lut[int(v)] for v in raw.tolist()])
            else:
                if np.dtype(f.atype.device_dtype) == np.dtype(np.float32):
                    raw = raw.view(np.float32)
                col_lists.append(f.decode_column(raw))
        rows = (
            list(zip(ts_list, map(tuple, zip(*col_lists))))
            if col_lists
            else [(t, ()) for t in ts_list]
        )
        return [(schema, rows)]

    def decode_packed_columns(self, n: int, block: np.ndarray,
                              lookup_np=None):
        """Columnar twin of :meth:`decode_packed`: group codes decode
        through an object-array LUT in one fancy index."""
        schema = self.output_schema
        gcp = self.group_code_proj
        if not gcp or all(g is None for g in gcp):
            return [(schema, schema.decode_packed_columns(n, block))]
        order = emission_order(block[0], n)
        ts_out = np.asarray(block[0, :n])[order].astype(np.int64)
        arr_cache = self.__dict__.setdefault("_lut_arr_cache", {})
        cols = {}
        for c, f in enumerate(schema.fields):
            raw = np.asarray(block[1 + c, :n])[order]
            if gcp[c] is not None:
                lut = self._lut(c, f, gcp[c])
                arr = arr_cache.get(c)
                if arr is None or len(arr) != len(lut):
                    arr = np.empty(len(lut), dtype=object)
                    arr[:] = lut
                    arr_cache[c] = arr
                cols[f.name] = arr[raw.astype(np.int64)]
            else:
                if np.dtype(f.atype.device_dtype) == np.dtype(np.float32):
                    raw = raw.view(np.float32)
                cols[f.name] = f.decode_column_np(raw)
        return [(schema, ColumnBatch(ts_out, cols))]

    # -- the sort path -----------------------------------------------------
    def _step_blocked(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        """Windowed per-group aggregates from one stable sort.

        The sequence is the ring (the last C matching events) followed by
        this batch's matching events, compacted: N = C + E entries, each
        with its group code, its live flag and its values. An entry p
        leaves the window at ``exp_rank[p]``, the first sequence position
        whose arrival excludes it (p + C for a length window; for a time
        window the first position whose running-maximum timestamp reaches
        ts[p] + span, as in the reference). After a stable sort by group
        code (ties keep sequence order), the group's entries that arrived
        through arrival q are one sorted range; those that left before q
        are another — of the same sort for a length window (the entries
        before position q - C + 1), of a sort by (group, exp_rank) for a
        time window. A window sum is the difference of the two ranges'
        sums, each a within-group prefix sum."""
        env: ColumnEnv = dict(tape.cols)
        mask = _query_mask(self, state, tape, env)
        E = tape.capacity
        C = self.capacity
        N = C + E
        ring = state["ring"]
        dev = mask.device

        M = mask.sum(dtype=_I32)
        rank = torch.cumsum(mask, 0, dtype=_I32) - 1
        dest = torch.where(mask, rank, E).long()

        def compact(col, dtype=None):
            col = as_column(col, E, tape.ts)
            if dtype is not None:
                col = col.to(dtype)
            out = torch.zeros(E + 1, dtype=col.dtype, device=dev)
            return out.scatter_(0, dest, col)[:E]

        arg_b = [compact(fn(env), ring[f"a{j}"].dtype)
                 for j, fn in enumerate(self.arg_fns)]
        codes_b = (compact(env[self.code_key], _I32)
                   if self.code_key is not None
                   else torch.zeros(E, dtype=_I32, device=dev))
        ts_b = compact(tape.ts)
        live_b = torch.arange(E, device=dev) < M
        live = torch.cat([ring["valid"], live_b])
        codes = torch.cat([ring["gc"], codes_b])
        ts_n = torch.cat([ring["ts"], ts_b])
        arg_n = [torch.cat([ring[f"a{j}"], b]) for j, b in enumerate(arg_b)]

        # arrivals in group order: a stable sort by group code keeps each
        # group's entries in sequence order
        codes_s, order = torch.sort(codes, stable=True)
        inv = _inverse(order)
        flags = torch.ones(N, dtype=torch.bool, device=dev)
        flags[1:] = codes_s[1:] != codes_s[:-1]
        # the arrivals: sequence position q = C + rank of each tape event;
        # its group's entries through q are the sorted range [start, hi]
        q = C + torch.clamp(rank, min=0).long()
        g_q = codes[q]
        hi = inv[q]
        start = torch.searchsorted(codes_s, g_q, side="left")
        base = g_q.long() * (N + 1)

        # the entries of q's group that left the window before q arrived:
        # the sorted range [x_lo, x_hi] of ordering x_order
        if self.window_mode == "length":
            # entry p leaves at p + C: the group's entries before q - C + 1
            keys = codes_s.long() * (N + 1) + order
            L = torch.clamp(q - C + 1, min=0)
            x_order, x_flags = order, flags
            x_lo = start
            x_hi = torch.searchsorted(keys, base + L, side="left") - 1
        else:
            # entry p leaves at exp_rank[p], the first position whose
            # running-maximum timestamp reaches ts[p] + span (and never
            # before p + 1); a straggler can leave before an older entry,
            # so the expired entries are found in a second sort, by
            # (group, exp_rank)
            pos = torch.arange(N, dtype=_I64, device=dev)
            mono = torch.cummax(ts_n, 0).values.long()
            tgt = torch.clamp(ts_n.long() + int(self.time_ms), max=_I32_MAX)
            exp_rank = torch.maximum(
                torch.searchsorted(mono, tgt, side="left"), pos + 1
            )
            x_keys, x_order = torch.sort(codes.long() * (N + 1) + exp_rank,
                                         stable=True)
            x_flags = torch.ones(N, dtype=torch.bool, device=dev)
            x_flags[1:] = (torch.div(x_keys[1:], N + 1, rounding_mode="floor")
                           != torch.div(x_keys[:-1], N + 1,
                                        rounding_mode="floor"))
            x_lo = torch.searchsorted(x_keys, base, side="left")
            x_hi = torch.searchsorted(x_keys, base + q, side="right") - 1

        def window_int(vals):
            """Window sums of an integer plane, exact in int64."""
            def prefix(o):
                p = torch.cumsum(torch.where(live, vals, 0)[o], 0, dtype=_I64)
                return torch.cat([p.new_zeros(1), p])

            p = prefix(order)
            px = p if x_order is order else prefix(x_order)
            return p[hi + 1] - p[start] - (px[x_hi + 1] - px[x_lo])

        def window_float(vals):
            """Window sums of a float plane from float64 within-group
            prefixes (segmented scans: no other group's magnitude enters
            them)."""
            v = torch.where(live, vals.to(torch.float64), 0.0)
            p = _seg_scan(flags, v[order], torch.add)
            px = (p if x_order is order
                  else _seg_scan(x_flags, v[x_order], torch.add))
            gone = px[torch.clamp(x_hi, min=0)]
            return p[hi] - torch.where(x_hi >= x_lo, gone, 0.0)

        cnt_i = window_int(torch.ones(N, dtype=_I64, device=dev))
        cnt = cnt_i.to(torch.float32)
        sums: Dict[int, torch.Tensor] = {}
        for j in sorted({a.arg_idx for a in self.aggs
                         if a.kind in ("sum", "avg", "stddev")}):
            if arg_n[j].dtype.is_floating_point:
                sums[j] = window_float(arg_n[j]).to(torch.float32)
            else:
                # modular int32, as the reference's digit planes wrap
                sums[j] = window_int(arg_n[j].long()).to(_I32)
        minmax = [a for a in self.aggs if a.kind in ("min", "max")]
        ext = (self._blocked_extrema(minmax, arg_n, live, order, hi,
                                     cnt_i, N)
               if minmax else {})
        for agg in self.aggs:
            j = agg.arg_idx
            if agg.kind == "count":
                rows = cnt_i
            elif agg.kind in ("min", "max"):
                rows = ext[(agg.kind, j)]
            elif agg.kind == "sum":
                rows = sums[j]
            else:
                c_ = torch.clamp(cnt, min=1.0)
                mean = sums[j].to(torch.float32) / c_
                if agg.kind == "avg":
                    rows = mean
                else:  # stddev: squares in float32, as the reference's
                    sq = arg_n[j].to(torch.float32)
                    rows = torch.sqrt(torch.clamp(
                        window_float(sq * sq).to(torch.float32) / c_
                        - mean * mean, min=0.0,
                    ))
            env[agg.slot] = torch.where(
                mask, rows, 0).to(_dt(agg.out_type))

        gcp = self.group_code_proj or (None,) * len(self.proj_fns)
        cols = tuple(
            as_column(env[self.code_key] if gi is not None else p(env),
                      E, tape.ts)
            for p, gi in zip(self.proj_fns, gcp)
        )
        out_mask = mask
        if self.having_fn is not None:
            henv = dict(env)
            for f, c_ in zip(self.output_schema.fields, cols):
                henv[f"@out:{f.name}"] = c_
            out_mask = out_mask & self.having_fn(henv)

        # FIFO ring: the last C entries of [ring ++ arrivals], gathered at
        # M + arange(C) (M stays on the device)
        keep = M.long() + torch.arange(C, device=dev)
        new_ring = {"ts": ts_n[keep], "valid": live[keep], "gc": codes[keep]}
        for j, a in enumerate(arg_n):
            new_ring[f"a{j}"] = a[keep]
        new_state = {"enabled": state["enabled"], "ring": new_ring,
                     "groups": state["groups"]}
        return new_state, (out_mask, tape.ts, cols)

    def _blocked_extrema(self, minmax, arg_n, live, order, hi, cnt, N):
        """min/max for length windows: the window's live members are the
        last ``cnt`` same-group entries up to the arrival, a contiguous
        range of the sort by group code (the entries before the live ones
        of a group are never live). A sparse table over the sorted values
        (log-depth build, two gathers per arrival) answers each range."""
        cnt_q = torch.clamp(cnt, min=1)
        levels = max(1, int(np.ceil(np.log2(max(N, 2)))))
        lvl = torch.zeros_like(cnt_q)
        for k in range(1, levels + 1):
            lvl = lvl + (cnt_q >= (1 << k)).long()
        pow_l = torch.ones_like(lvl) << lvl
        out: Dict = {}
        for agg in minmax:
            vals = arg_n[agg.arg_idx]
            combine = torch.minimum if agg.kind == "min" else torch.maximum
            ident = _identity(agg.kind, vals.dtype)
            table = [torch.where(live, vals, ident)[order]]
            for k in range(levels):
                span = 1 << k
                prev = table[-1]
                table.append(combine(prev, torch.cat([
                    torch.full((span,), ident, dtype=prev.dtype,
                               device=prev.device),
                    prev[:-span],
                ])))
            flat = torch.stack(table).reshape(-1)
            v1 = flat[lvl * N + hi]
            r2 = torch.clamp(hi - cnt_q + pow_l, 0, N - 1)
            out[(agg.kind, agg.arg_idx)] = combine(v1, flat[lvl * N + r2])
        return out

    # -- the matrix path ---------------------------------------------------
    def _step_matrix(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        env: ColumnEnv = dict(tape.cols)
        mask = _query_mask(self, state, tape, env)
        E = tape.capacity
        C = self.capacity
        ring = state["ring"]
        dev = mask.device

        # matching first, stable
        order = torch.sort((~mask).to(torch.uint8), stable=True).indices
        M = mask.sum(dtype=_I32)
        rank = torch.cumsum(mask, 0, dtype=_I32) - 1

        def cat(ring_col, col):
            col = as_column(col, E, tape.ts)
            return torch.cat([ring_col, col[order].to(ring_col.dtype)])

        c_cols: Dict[str, torch.Tensor] = {}
        for j, fn in enumerate(self.arg_fns):
            c_cols[f"a{j}"] = cat(ring[f"a{j}"], fn(env))
        for j, fn in enumerate(self.group_fns):
            c_cols[f"g{j}"] = cat(ring[f"g{j}"], fn(env))
        ts_col = env[self.ts_key] if self.ts_key else tape.ts
        c_cols["ts"] = cat(ring["ts"], ts_col)
        cval = torch.cat([ring["valid"], torch.arange(E, device=dev) < M])

        # every row k = the last C matching events ending at compacted k
        idx = (torch.arange(E, device=dev)[:, None] + 1
               + torch.arange(C, device=dev)[None, :])
        win = {k: v[idx] for k, v in c_cols.items()}
        member = cval[idx]
        if self.window_mode in ("time", "timeLength"):
            cur_ts = win["ts"][:, -1:]
            member = member & (win["ts"] > cur_ts - int(self.time_ms))
        for j in range(len(self.group_fns)):
            g = win[f"g{j}"]
            member = member & (g == g[:, -1:])

        r_idx = torch.clamp(rank, min=0).long()
        for agg in self.aggs:
            rows = self._reduce(agg, member, win)
            env[agg.slot] = torch.where(
                mask, rows[r_idx], 0).to(_dt(agg.out_type))
        cols, out_mask = _project(self, env, E, tape.ts, mask)

        keep = M.long() + torch.arange(C, device=dev)
        new_ring = {k: v[keep] for k, v in c_cols.items()}
        new_ring["valid"] = cval[keep]
        new_state = {"enabled": state["enabled"], "ring": new_ring}
        return new_state, (out_mask, tape.ts, cols)

    def _reduce(self, agg: _Agg, member, win):
        if agg.kind == "count":
            return member.sum(1)
        vals = win[f"a{agg.arg_idx}"]
        if agg.kind == "sum":
            # an int32 sum wraps as the reference's (taken modulo 2^32)
            return torch.where(member, vals, 0).sum(1).to(vals.dtype)
        if agg.kind in ("min", "max"):
            masked = torch.where(member, vals, _identity(agg.kind,
                                                         vals.dtype))
            return masked.amin(1) if agg.kind == "min" else masked.amax(1)
        c = torch.clamp(member.sum(1), min=1)
        if agg.kind == "avg":
            return torch.where(member, vals, 0).to(torch.float32).sum(1) / c
        if agg.kind == "stddev":
            v = vals.to(torch.float32)
            s = torch.where(member, v, 0.0).sum(1)
            s2 = torch.where(member, v * v, 0.0).sum(1)
            mean = s / c
            return torch.sqrt(torch.clamp(s2 / c - mean * mean, min=0.0))
        if agg.kind == "distinctcount":
            # first-occurrence count within each row's window
            eq = vals[:, :, None] == vals[:, None, :]
            both = member[:, :, None] & member[:, None, :]
            n = eq.shape[1]
            earlier = torch.tril(
                torch.ones((n, n), dtype=torch.bool, device=vals.device),
                diagonal=-1,
            )
            dup = (eq & both & earlier[None]).any(2)
            return (member & ~dup).sum(1)
        raise AssertionError(agg.kind)


# --------------------------------------------------------------------------
# Cumulative aggregation (no window): per-group state table + segmented scan
# --------------------------------------------------------------------------

@dataclass
class CumulativeAggArtifact:
    name: str
    output_schema: OutputSchema
    stream_code: int
    filter_fns: List
    aggs: List[_Agg]
    arg_fns: List[Callable]
    arg_types: List[AttributeType]
    code_key: Optional[str]  # encoded group column; None -> single group
    encoder: Optional[GroupEncoder]
    proj_fns: List
    having_fn: Optional[Callable]
    output_mode: str = "aligned"
    # chained-input group-by: the group VALUES exist only on the device
    # (the producer's emissions), so instead of a host-built code column
    # the device maps values -> codes through a sorted intern table synced
    # from the (intern-only) host encoder (plan._rewire_chained_group)
    chained_group_src: Optional[str] = None
    chained_group_dtype: object = None

    def cost_info(self) -> Dict:
        """Admission-cost descriptor: running aggregates — one row per
        event, no events retained (per-group scalar state only)."""
        info = {
            "name": self.name,
            "kind": "aggregate",
            "amplification": 1,
            "residency_ms": 0,
        }
        if self.encoder is not None:
            info["grows_with"] = "groups"
        return info

    def _stats(self) -> Dict[int, set]:
        return _acc_stats_for(self.aggs)

    def _G(self) -> int:
        if self.encoder is None:
            return 1
        return _bucket(len(self.encoder), MIN_GROUP_CAPACITY)

    def _chained_tables(self, G: int, device) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
        """(sorted values, codes) ``[G]`` for the device value->code map,
        made on the host from the encoder and cached on (encoder size, G,
        device): while the encoder does not grow, every step reads the
        same two tensors (no upload)."""
        key = (len(self.encoder), G, str(device))
        cached = getattr(self, "_ct_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1], cached[2]
        dt = np.dtype(self.chained_group_dtype)
        vals = np.asarray(
            [self.encoder.value(i)[0] for i in range(len(self.encoder))],
            dtype=dt,
        )
        order = np.argsort(vals, kind="stable")
        gv = np.full(G, np.inf if np.issubdtype(dt, np.floating)
                     else np.iinfo(dt).max, dtype=dt)
        gc = np.zeros(G, np.int32)
        gv[: len(vals)] = vals[order]
        gc[: len(vals)] = order.astype(np.int32)
        out = (torch.from_numpy(gv).to(device),
               torch.from_numpy(gc).to(device))
        self._ct_cache = (key, *out)
        return out

    def _group_codes(self, env, state) -> torch.Tensor:
        """Group code per tape position: the host-built code column, or
        the on-device sorted-table lookup for chained inputs."""
        if self.chained_group_src is None:
            return env[self.code_key].to(_I32)
        gv = state["@gv"]
        vals = env[self.chained_group_src].to(gv.dtype)
        pos = torch.clamp(torch.searchsorted(gv, vals, side="left"),
                          0, gv.shape[0] - 1)
        return state["@gc"][pos]

    def init_state(self, device) -> Dict:
        G = self._G()
        st = {"enabled": torch.tensor(True, device=device),
              "cnt": torch.zeros(G, dtype=_I32, device=device)}
        if self.chained_group_src is not None:
            st["@gv"], st["@gc"] = self._chained_tables(G, device)
        # float sums carry a Neumaier compensation: an UNBOUNDED float32
        # running sum otherwise loses every update once its magnitude
        # outgrows the mantissa
        st.update(_stat_tables(self._stats(), self.arg_types, G, device,
                               compensated=True))
        return st

    def grow_state(self, state: Dict) -> Dict:
        need = self._G()
        G = int(state["cnt"].shape[0])
        if need > G:
            state = _pad_groups(state, need)
            G = need
        if self.chained_group_src is not None:
            gv, gc = self._chained_tables(G, state["cnt"].device)
            if gv is not state["@gv"]:
                state = dict(state, **{"@gv": gv, "@gc": gc})
        return state

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        env: ColumnEnv = dict(tape.cols)
        mask = _query_mask(self, state, tape, env)
        E = tape.capacity
        G = int(state["cnt"].shape[0])
        dev = mask.device

        g = (self._group_codes(env, state) if self.code_key is not None
             else torch.zeros(E, dtype=_I32, device=dev))
        segkey = torch.where(mask, g, G).long()
        # stable: groups contiguous, in tape order, pad last
        g_s, order = torch.sort(segkey, stable=True)
        inv = _inverse(order)
        flags = torch.ones(E, dtype=torch.bool, device=dev)
        flags[1:] = g_s[1:] != g_s[:-1]
        ends = torch.ones_like(flags)
        ends[:-1] = flags[1:]
        gather_g = torch.clamp(g_s, max=G - 1)
        mask_s = mask[order]

        # per-event running count (prefix within batch + carried totals)
        ones = torch.ones(E, dtype=_I32, device=dev)
        pre_cnt = _seg_scan(flags, ones, torch.add) + state["cnt"][gather_g]
        stats_env: Dict[str, torch.Tensor] = {"cnt": pre_cnt[inv]}
        new_state = dict(state)
        new_state["cnt"] = state["cnt"] + _segment_reduce(
            mask.to(_I32), segkey, G, "sum")

        for arg_idx, stats in self._stats().items():
            v = as_column(self.arg_fns[arg_idx](env), E, tape.ts)
            v_s = v[order]
            for s in stats:
                key = f"{s}{arg_idx}"
                acc = state[key]
                if s in ("sum", "sumsq"):
                    vv_s = v_s.to(acc.dtype)
                    if s == "sumsq":
                        vv_s = vv_s * vv_s
                    vv_s = torch.where(mask_s, vv_s, 0)
                    kc = state.get(f"kc_{key}")
                    if kc is None:
                        # integer accumulators are exact: plain scan
                        pre = _seg_scan(flags, vv_s, torch.add) \
                            + acc[gather_g]
                        stats_env[key] = pre[inv]
                        new_state[key] = acc + _segment_reduce(
                            vv_s[inv], segkey, G, "sum")
                    else:
                        # float running sums: compensated scan within the
                        # batch + Neumaier two-sum into the carried
                        # accumulator. The batch totals are the scan's
                        # segment ends, one per group (a fixed order)
                        s_scan, c_scan = _seg_scan_sum_kahan(flags, vv_s)
                        base = acc + kc
                        pre = (s_scan + c_scan) + base[gather_g]
                        stats_env[key] = pre[inv]
                        gi = torch.where(ends & (g_s < G), g_s, G)
                        tot = torch.zeros(G + 1, dtype=acc.dtype,
                                          device=dev)
                        tot.index_put_((gi,), torch.where(ends, s_scan, 0.0))
                        tot_c = torch.zeros_like(tot)
                        tot_c.index_put_((gi,),
                                         torch.where(ends, c_scan, 0.0))
                        tot, tot_c = tot[:G], tot_c[:G]
                        t = acc + tot
                        err = torch.where(acc.abs() >= tot.abs(),
                                          (acc - t) + tot, (tot - t) + acc)
                        new_state[key] = t
                        new_state[f"kc_{key}"] = kc + err + tot_c
                else:
                    ident = _identity(s, acc.dtype)
                    comb = torch.minimum if s == "min" else torch.maximum
                    vv_s = torch.where(mask_s, v_s.to(acc.dtype), ident)
                    pre = comb(_seg_scan(flags, vv_s, comb), acc[gather_g])
                    stats_env[key] = pre[inv]
                    tot = _segment_reduce(
                        torch.where(mask, v.to(acc.dtype), ident), segkey,
                        G, s)
                    new_state[key] = comb(acc, tot)

        for agg in self.aggs:
            env[agg.slot] = _agg_from_stats(agg, stats_env).to(
                _dt(agg.out_type))
        cols, out_mask = _project(self, env, E, tape.ts, mask)
        return new_state, (out_mask, tape.ts, cols)


# --------------------------------------------------------------------------
# Batch (tumbling) windows: lengthBatch / timeBatch segment grids
# --------------------------------------------------------------------------

@dataclass
class BatchWindowArtifact:
    name: str
    output_schema: OutputSchema
    stream_code: int
    filter_fns: List
    window_mode: str  # 'lengthBatch' | 'timeBatch'
    length: Optional[int]  # lengthBatch n
    time_ms: Optional[int]  # timeBatch span
    aggs: List[_Agg]
    arg_fns: List[Callable]
    arg_types: List[AttributeType]
    code_key: Optional[str]
    encoder: Optional[GroupEncoder]
    # non-aggregate projection inputs: "last event of the group in the
    # window" values, keyed by tape column
    last_keys: List[str]
    last_types: List[AttributeType]
    proj_fns: List
    having_fn: Optional[Callable]
    output_mode: str = "buffered"
    batch_slots: int = 64
    # externalTimeBatch: window boundaries follow this tape column's
    # values instead of event time
    ts_key: Optional[str] = None
    # cron: window boundaries are host-computed per-event window ids
    # (utils/cron.py). A window completes when a LATER-window event
    # exists — the event-driven equivalent of the timer firing
    wid_key: Optional[str] = None

    def cost_info(self) -> Dict:
        """Admission-cost descriptor: batch windows emit one aggregate
        row per closed window per group — per input event that is
        amortized <= 1; retention is one batch span."""
        res = None
        if self.window_mode == "timeBatch" and self.time_ms is not None:
            res = int(self.time_ms)
        info = {
            "name": self.name,
            "kind": "batch_window",
            "amplification": 1,
            "residency_ms": res,
        }
        if self.encoder is not None:
            info["grows_with"] = "groups"
        return info

    def emit_block_width(self, tape_capacity: int, state: Dict) -> int:
        """Widest per-cycle emission block: every window-grid cell can
        flush (drain-cadence contract)."""
        return self._grid_shape(tape_capacity) * self._G(state)

    def _G(self, state) -> int:
        return int(state["cnt"].shape[0])

    def _stats(self) -> Dict[int, set]:
        return _acc_stats_for(self.aggs)

    def init_state(self, device) -> Dict:
        G = (_bucket(len(self.encoder), MIN_GROUP_CAPACITY)
             if self.encoder is not None else 1)

        def scalar(v):
            return torch.tensor(v, dtype=_I32, device=device)

        st = {
            "enabled": torch.tensor(True, device=device),
            # the current (incomplete) window's accumulators, per group
            "cnt": torch.zeros(G, dtype=_I32, device=device),
            "ts": torch.zeros(G, dtype=_I32, device=device),
            "seen": scalar(0),  # total matching ever
            "batch": scalar(-1),  # current window ordinal
            "t0": scalar(-1),  # first-ever event ts
        }
        st.update(_stat_tables(self._stats(), self.arg_types, G, device,
                               compensated=False))
        for j, t in enumerate(self.last_types):
            st[f"last{j}"] = torch.zeros(G, dtype=_dt(t), device=device)
        return st

    def grow_state(self, state: Dict) -> Dict:
        if self.encoder is None:
            return state
        need = _bucket(len(self.encoder), MIN_GROUP_CAPACITY)
        if need <= self._G(state):
            return state
        return _pad_groups(state, need)

    def _grid_shape(self, E: int) -> int:
        if self.window_mode == "lengthBatch":
            return E // self.length + 2
        return self.batch_slots + 1

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        env: ColumnEnv = dict(tape.cols)
        mask = _query_mask(self, state, tape, env)
        E = tape.capacity
        G = self._G(state)
        B = self._grid_shape(E)
        NS = B * G
        dev = mask.device
        rows = torch.arange(B, dtype=_I32, device=dev)

        g = (env[self.code_key].to(_I32) if self.code_key is not None
             else torch.zeros(E, dtype=_I32, device=dev))
        M = mask.sum(dtype=_I32)
        rank = torch.cumsum(mask, 0, dtype=_I32) - 1  # matching ordinal

        if self.window_mode == "lengthBatch":
            n = self.length
            seq = state["seen"] + rank  # global matching ordinal
            abs_batch = torch.div(seq, n, rounding_mode="floor")
            first_batch = torch.clamp(state["batch"], min=0)
            row = abs_batch - first_batch  # the carry merges into row 0
            new_seen = state["seen"] + M
            new_batch = torch.where(
                new_seen > 0, torch.div(new_seen, n, rounding_mode="floor"),
                -1).to(_I32)
            t0 = state["t0"]
            # row r (window first_batch + r) is complete when its last
            # ordinal exists: (first_batch + r + 1) * n <= new_seen
            completed = (first_batch + rows + 1) * n <= new_seen
        else:
            T = self.time_ms
            ts = (env[self.ts_key].to(_I32) if self.ts_key is not None
                  else tape.ts)
            if self.wid_key is not None:  # cron window ids, host-made
                t0 = state["t0"]
                abs_batch = torch.where(mask, env[self.wid_key].to(_I32), 0)
            else:
                first_ts = torch.where(
                    M > 0, torch.where(mask, ts, _I32_MAX).min(), 0)
                t0 = torch.where(state["t0"] >= 0, state["t0"],
                                 first_ts).to(_I32)
                abs_batch = torch.where(
                    mask, torch.div(ts - t0, T, rounding_mode="floor"), 0
                ).to(_I32)
            # dense-rank the distinct windows of this tape; the carried
            # window is row 0 (merging when the tape still starts in it)
            sortable = torch.where(mask, abs_batch, _I32_MAX)
            ab_s, order = torch.sort(sortable, stable=True)
            newrun = torch.zeros(E, dtype=_I32, device=dev)
            newrun[1:] = (ab_s[1:] != ab_s[:-1]).to(_I32)
            rank_s = torch.cumsum(newrun, 0, dtype=_I32)
            dense = rank_s[_inverse(order)]
            carry_batch = state["batch"]
            tape_first_batch = torch.where(M > 0, ab_s[0], carry_batch)
            shift = ((carry_batch >= 0)
                     & (tape_first_batch != carry_batch)).to(_I32)
            row = dense + shift
            first_batch = torch.where(carry_batch >= 0, carry_batch,
                                      tape_first_batch)
            # the absolute window of each row, for the completion checks
            # (rows past the grid drop, as JAX drops segment ids past it)
            row_seg = torch.where(mask & (row < B), row, B).long()
            row_batch = _segment_reduce(
                torch.where(mask, abs_batch, _NEG), row_seg, B, "max")
            row_batch = torch.cat([
                torch.where(carry_batch >= 0, carry_batch,
                            row_batch[0]).reshape(1),
                row_batch[1:],
            ])
            last_ts = torch.where(mask, ts, _NEG).max()
            max_tape_batch = torch.where(mask, abs_batch, _NEG).max()
            if self.wid_key is not None:
                # cron: a window is complete once a LATER-window event
                # exists
                latest = torch.maximum(carry_batch, max_tape_batch)
                completed = (row_batch > _NEG) & (row_batch < latest)
            else:
                # a window is complete once an event at/after its end
                # exists
                completed = (row_batch > _NEG) & (
                    last_ts >= t0 + (row_batch + 1) * T)
            new_seen = state["seen"] + M
            new_batch = torch.where(
                M > 0, torch.maximum(carry_batch, max_tape_batch),
                carry_batch)

        row = torch.clamp(row, 0, B - 1)
        seg = torch.where(mask, row * G + g, NS).long()

        # --- aggregate the (row, group) grid -------------------------------
        tape_cnt = _segment_reduce(mask.to(_I32), seg, NS, "sum").view(B, G)
        had_tape = tape_cnt > 0
        cnt_grid = tape_cnt.clone()
        cnt_grid[0] += state["cnt"]
        ts_grid = _segment_reduce(torch.where(mask, tape.ts, _NEG), seg, NS,
                                  "max").view(B, G).clone()
        ts_grid[0] = torch.maximum(
            ts_grid[0], torch.where(state["cnt"] > 0, state["ts"], _NEG))

        stat_grids: Dict[str, torch.Tensor] = {}
        for arg_idx, stats in self._stats().items():
            v = as_column(self.arg_fns[arg_idx](env), E, tape.ts)
            for s in stats:
                key = f"{s}{arg_idx}"
                acc = state[key]
                if s in ("sum", "sumsq"):
                    vv = v.to(acc.dtype)
                    if s == "sumsq":
                        vv = vv * vv
                    grid = _segment_reduce(torch.where(mask, vv, 0), seg,
                                           NS, "sum").view(B, G).clone()
                    grid[0] += acc
                else:
                    ident = _identity(s, acc.dtype)
                    comb = torch.minimum if s == "min" else torch.maximum
                    grid = _segment_reduce(
                        torch.where(mask, v.to(acc.dtype), ident), seg, NS,
                        s).view(B, G).clone()
                    grid[0] = comb(grid[0], acc)
                stat_grids[key] = grid

        # last-event values per cell (for non-aggregate projections): the
        # one winner of each cell lands by a sum of zeros and itself
        ord_grid = _segment_reduce(torch.where(mask, rank, -1), seg, NS,
                                   "max")
        winner = mask & (rank == ord_grid[torch.clamp(seg, max=NS - 1)])
        last_grids: Dict[str, torch.Tensor] = {}
        for j, key in enumerate(self.last_keys):
            v = env[key]
            sum_dtype = _I32 if v.dtype == torch.bool else v.dtype
            tape_last = torch.zeros(NS + 1, dtype=sum_dtype, device=dev)
            tape_last.index_add_(0, seg, torch.where(winner, v, 0)
                                 .to(sum_dtype))
            tape_last = tape_last[:NS].view(B, G).to(v.dtype)
            merged = torch.where(had_tape, tape_last, 0).to(v.dtype)
            merged[0] = torch.where(had_tape[0], tape_last[0],
                                    state[f"last{j}"])
            last_grids[key] = merged

        # --- flush completed cells ----------------------------------------
        flat = ((cnt_grid > 0) & completed[:, None]).reshape(NS)
        stats_flat = {k: v.reshape(NS) for k, v in stat_grids.items()}
        stats_flat["cnt"] = cnt_grid.reshape(NS)
        fenv: ColumnEnv = {key: grid.reshape(NS)
                           for key, grid in last_grids.items()}
        for agg in self.aggs:
            fenv[agg.slot] = _agg_from_stats(agg, stats_flat).to(
                _dt(agg.out_type))
        cols, out_mask = _project(self, fenv, NS, tape.ts, flat)
        ford = torch.sort((~out_mask).to(torch.uint8), stable=True).indices
        count = out_mask.sum(dtype=_I32)
        out_ts = ts_grid.reshape(NS)[ford]
        out_cols = tuple(c[ford] for c in cols)

        # --- carry: the last (incomplete) window ---------------------------
        new_state = dict(state)
        new_state["seen"] = new_seen
        new_state["batch"] = new_batch
        new_state["t0"] = t0
        if self.window_mode == "lengthBatch":
            inc_row = torch.clamp(new_batch - first_batch, 0, B - 1)
            inc_live = torch.ones((), dtype=torch.bool, device=dev)
        else:
            last_rank = _take(rank_s, torch.clamp(M - 1, min=0))
            inc_row = torch.clamp(
                torch.where(M > 0, last_rank + shift, 0), 0, B - 1)
            inc_live = ~_take(completed, inc_row)

        def carry_of(grid, zero):
            return torch.where(inc_live, _take(grid, inc_row), zero)

        new_state["cnt"] = carry_of(cnt_grid, 0).to(_I32)
        new_state["ts"] = carry_of(ts_grid, 0).to(_I32)
        for key, grid in stat_grids.items():
            zero = (_identity(key[:3], grid.dtype)
                    if key.startswith(("min", "max")) else 0)
            new_state[key] = carry_of(grid, zero).to(grid.dtype)
        for j, key in enumerate(self.last_keys):
            new_state[f"last{j}"] = carry_of(last_grids[key], 0).to(
                state[f"last{j}"].dtype)
        return new_state, (count, out_ts, out_cols)

    @property
    def flush_is_noop(self) -> bool:
        return self.window_mode not in ("timeBatch", "cron")

    def flush(self, state: Dict) -> Tuple[Dict, Tuple]:
        """End-of-stream flush of the carried incomplete window (timeBatch
        semantics: the final timer fires; lengthBatch does not flush
        partial windows, matching Siddhi)."""
        G = self._G(state)
        dev = state["cnt"].device
        if self.flush_is_noop:
            return state, (
                torch.zeros((), dtype=_I32, device=dev),
                torch.zeros(G, dtype=_I32, device=dev),
                tuple(torch.zeros(G, dtype=_dt(f.atype), device=dev)
                      for f in self.output_schema.fields),
            )
        stats_flat = {"cnt": state["cnt"]}
        for key in state:
            if key[:3] in ("sum", "min", "max"):
                stats_flat[key] = state[key]
        fenv: ColumnEnv = {key: state[f"last{j}"]
                           for j, key in enumerate(self.last_keys)}
        for agg in self.aggs:
            fenv[agg.slot] = _agg_from_stats(agg, stats_flat).to(
                _dt(agg.out_type))
        cols, out_mask = _project(self, fenv, G, state["ts"],
                                  state["cnt"] > 0)
        ford = torch.sort((~out_mask).to(torch.uint8), stable=True).indices
        count = out_mask.sum(dtype=_I32)
        # closing the window early: every accumulator resets, or the next
        # step would re-add the flushed totals into row 0
        new_state = dict(state)
        for k, v in state.items():
            if v.dim() == 0:
                continue
            fill = (_identity(k[:3], v.dtype)
                    if k.startswith(("min", "max")) else 0)
            new_state[k] = torch.full_like(v, fill)
        return new_state, (
            count, state["ts"][ford], tuple(c[ford] for c in cols)
        )


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

def _window_of(inp: ast.StreamInput):
    """Classify the (at most one) window handler on a stream input."""
    if not inp.windows:
        return None
    if len(inp.windows) > 1:
        raise SiddhiQLError("at most one #window handler per stream input")
    w = inp.windows[0]
    name = w.name.split(".")[-1]
    lname = name.lower()
    if lname in ("length", "lengthbatch"):
        if len(w.args) != 1 or not isinstance(w.args[0], ast.Literal):
            raise SiddhiQLError(f"#window.{name} needs one integer argument")
        return ("length" if lname == "length" else "lengthBatch",
                int(w.args[0].value))
    if lname in ("time", "timebatch"):
        if len(w.args) != 1:
            raise SiddhiQLError(f"#window.{name} needs one time argument")
        return ("time" if lname == "time" else "timeBatch",
                _time_arg(w.args[0]))
    if lname == "externaltime":
        if len(w.args) != 2 or not isinstance(w.args[0], ast.Attr):
            raise SiddhiQLError(
                "#window.externalTime needs (tsAttribute, duration)"
            )
        return ("externalTime", (w.args[0], _time_arg(w.args[1])))
    if lname == "externaltimebatch":
        if len(w.args) != 2 or not isinstance(w.args[0], ast.Attr):
            raise SiddhiQLError(
                "#window.externalTimeBatch needs (tsAttribute, duration)"
            )
        return ("externalTimeBatch", (w.args[0], _time_arg(w.args[1])))
    if lname == "session":
        if not w.args or len(w.args) > 2:
            raise SiddhiQLError(
                "#window.session needs (gap[, keyAttribute])"
            )
        key = None
        if len(w.args) == 2:
            if not isinstance(w.args[1], ast.Attr):
                raise SiddhiQLError(
                    "#window.session key must be an attribute"
                )
            key = w.args[1]
        return ("session", (_time_arg(w.args[0]), key))
    if lname == "delay":
        if len(w.args) != 1:
            raise SiddhiQLError("#window.delay needs one time argument")
        return ("delay", _time_arg(w.args[0]))
    if lname == "timelength":
        if len(w.args) != 2 or not isinstance(w.args[1], ast.Literal):
            raise SiddhiQLError(
                "#window.timeLength needs (duration, count)"
            )
        return ("timeLength", (_time_arg(w.args[0]), int(w.args[1].value)))
    if lname in ("sort", "unique"):
        return (lname, tuple(w.args))
    if lname == "frequent":
        if not w.args or not isinstance(w.args[0], ast.Literal):
            raise SiddhiQLError(
                "#window.frequent needs (count[, attributes...])"
            )
        return ("frequent", tuple(w.args))
    if lname == "lossyfrequent":
        if not w.args or not isinstance(w.args[0], ast.Literal):
            raise SiddhiQLError(
                "#window.lossyFrequent needs "
                "(supportThreshold[, errorBound][, attributes...])"
            )
        return ("lossyFrequent", tuple(w.args))
    if lname == "cron":
        if len(w.args) != 1 or not isinstance(w.args[0], ast.Literal):
            raise SiddhiQLError(
                "#window.cron needs one cron-expression string"
            )
        return ("cron", str(w.args[0].value))
    raise SiddhiQLError(f"unsupported window #window.{w.name}")


def _time_arg(a: ast.Expr) -> int:
    if isinstance(a, ast.TimeLiteral):
        return a.ms
    if isinstance(a, ast.Literal) and isinstance(a.value, int):
        return a.value
    raise SiddhiQLError("expected a time duration argument")


def _stream_scope(q: ast.Query, schemas):
    """The resolver of a single-stream query and its compiled filters."""
    inp = q.input
    ref = inp.ref_name
    scopes = {ref: (inp.stream_id, schemas[inp.stream_id])}
    if ref != inp.stream_id:
        scopes[inp.stream_id] = (inp.stream_id, schemas[inp.stream_id])
    return ExprResolver(scopes, default_scope=ref)


def _filters(inp: ast.StreamInput, resolver, extensions) -> List:
    filter_fns = []
    for f in inp.filters:
        ce = compile_expr(f, resolver, extensions)
        if ce.atype != AttributeType.BOOL:
            raise SiddhiQLError("stream filter must be boolean")
        filter_fns.append(ce.fn)
    return filter_fns


def _select_items(q: ast.Query, schemas):
    items = q.selector.items
    if q.selector.is_star:
        schema = schemas[q.input.stream_id]
        items = tuple(
            ast.SelectItem(ast.Attr(n), None) for n in schema.field_names
        )
    return items


def compile_window_query(
    q: ast.Query,
    name: str,
    schemas,
    stream_codes: Dict[str, int],
    extensions,
    config=None,
):
    """A stream query with a window, aggregates or group-by."""
    from .config import DEFAULT_CONFIG

    config = config or DEFAULT_CONFIG
    inp = q.input
    assert isinstance(inp, ast.StreamInput)
    resolver = _stream_scope(q, schemas)
    filter_fns = _filters(inp, resolver, extensions)
    items = _select_items(q, schemas)

    group_names = q.selector.group_by
    collector = _AggCollector(resolver, extensions)
    rewritten = [
        ast.SelectItem(collector.rewrite(i.expr), i.alias) for i in items
    ]
    having_re = (
        collector.rewrite(q.selector.having)
        if q.selector.having is not None
        else None
    )

    window = _window_of(inp)
    if not collector.aggs and not group_names:
        # window with plain projection: current-event output == stateless
        # select (Siddhi emits arriving events unchanged for `insert into`)
        from .select import compile_select

        return compile_select(
            q, name, resolver, schemas, stream_codes[inp.stream_id],
            extensions,
        )

    if window is not None and window[0] in (
        "sort", "unique", "session", "frequent", "lossyFrequent",
    ):
        from .scan_windows import compile_scan_window

        return compile_scan_window(
            q, name, window, resolver, schemas, stream_codes, extensions,
            filter_fns, rewritten, collector, having_re,
        )

    slot_types = {a.slot: a.out_type for a in collector.aggs}
    slot_resolver = _SlotResolver(resolver, slot_types)
    proj_fns: List = []
    out_fields: List[OutputField] = []
    for item in rewritten:
        ce = compile_expr(item.expr, slot_resolver, extensions)
        proj_fns.append(ce.fn)
        out_fields.append(OutputField(item.output_name(), ce.atype, ce.table))

    having_fn = None
    if having_re is not None:
        # having may reference select aliases; map alias -> @out slot
        alias_slots = {f.name: f.atype for f in out_fields}

        class _HavingResolver:
            def resolve(self, attr: ast.Attr) -> ResolvedAttr:
                if attr.qualifier is None and attr.index is None:
                    if attr.name in slot_types:
                        return ResolvedAttr(
                            attr.name, slot_types[attr.name], None
                        )
                    if attr.name in alias_slots:
                        return ResolvedAttr(
                            f"@out:{attr.name}", alias_slots[attr.name], None
                        )
                return resolver.resolve(attr)

        ce = compile_expr(having_re, _HavingResolver(), extensions)
        if ce.atype != AttributeType.BOOL:
            raise SiddhiQLError("having clause must be boolean")
        having_fn = ce.fn

    out_schema = OutputSchema(q.output_stream, tuple(out_fields))
    sc = stream_codes[inp.stream_id]
    group_resolved = [
        resolver.resolve(ast.split_group_key(n)) for n in group_names
    ]
    code_key, encoder, encoded = _group_encoding(
        name, group_resolved, sc, filter_fns
    )

    if q.partition_with and window is not None and window[0] != "time":
        # a per-partition window: each key's own last C events. (A time
        # window inside a partition is the shared time window grouped by
        # the key, below: expiry does not depend on the key, so each key's
        # members are the same either way; _rewrite_partitioned put the
        # key in group_by.)
        if window[0] != "length":
            raise SiddhiQLError(
                f"#window.{window[0]} inside 'partition with' is not "
                "supported yet (length and time windows only)"
            )
        attr = dict(q.partition_with).get(inp.stream_id)
        if tuple(ast.bare_group_key(n) for n in group_names) != (attr,):
            raise SiddhiQLError(
                "additional 'group by' inside a partitioned window "
                "query is not supported yet (the partition key is the "
                "grouping)"
            )
        art = PerKeyWindowArtifact(
            name=name,
            output_schema=out_schema,
            stream_code=sc,
            filter_fns=filter_fns,
            capacity=int(window[1]),
            aggs=collector.aggs,
            arg_fns=collector.arg_fns,
            arg_types=collector.arg_types,
            code_key=code_key,
            encoder=encoder,
            proj_fns=proj_fns,
            having_fn=having_fn,
        )
        art.encoded_columns = encoded
        return art

    if window is None:
        art = CumulativeAggArtifact(
            name=name,
            output_schema=out_schema,
            stream_code=sc,
            filter_fns=filter_fns,
            aggs=collector.aggs,
            arg_fns=collector.arg_fns,
            arg_types=collector.arg_types,
            code_key=code_key,
            encoder=encoder,
            proj_fns=proj_fns,
            having_fn=having_fn,
        )
        art.encoded_columns = encoded
        return art

    if window[0] in ("length", "time", "externalTime", "timeLength"):
        if window[0] == "length":
            mode, cap, time_ms, ts_key = "length", window[1], None, None
        elif window[0] == "time":
            mode, cap, time_ms, ts_key = (
                "time", config.time_window_capacity, window[1], None,
            )
        elif window[0] == "timeLength":
            # last-n AND within-t: the window matrix bounds membership to
            # the most recent `count` matching events and the member mask
            # adds the time cut — exactly min(time, length)
            dur, n = window[1]
            mode, cap, time_ms, ts_key = "timeLength", n, dur, None
        else:  # externalTime
            ts_attr, dur = window[1]
            mode, cap, time_ms, ts_key = (
                "time", config.time_window_capacity, dur,
                resolver.resolve(ts_attr).key,
            )
        # wire-opt metadata from the ORIGINAL (pre-rewrite) selector:
        # plain-ref sources, full per-item refs (incl. aggregate args),
        # filter refs
        art = SlidingWindowArtifact(
            name=name,
            output_schema=out_schema,
            stream_code=sc,
            filter_fns=filter_fns,
            window_mode=mode,
            capacity=cap,
            time_ms=time_ms,
            ts_key=ts_key,
            aggs=collector.aggs,
            arg_fns=collector.arg_fns,
            arg_types=collector.arg_types,
            group_fns=[lambda env, k=r.key: env[k] for r in group_resolved],
            group_dtypes=[r.atype.device_dtype for r in group_resolved],
            proj_fns=proj_fns,
            having_fn=having_fn,
            code_key=code_key,
            encoder=encoder,
            proj_srcs=tuple(
                resolver.resolve(i.expr).key
                if isinstance(i.expr, ast.Attr) and i.expr.index is None
                else None
                for i in items
            ),
            proj_refs=tuple(
                frozenset(resolver.resolve(a).key
                          for a in ast.iter_attrs(i.expr))
                for i in items
            ),
            filter_keys=frozenset(
                resolver.resolve(a).key
                for f in inp.filters
                for a in ast.iter_attrs(f)
            ),
            group_keys_=tuple(r.key for r in group_resolved),
        )
        if art._blocked():
            # the sort path consumes dense host-interned group codes off
            # the tape
            art.encoded_columns = encoded
        else:
            # the matrix path reads raw group columns; don't pay host
            # interning for a code column nobody reads
            art.code_key = None
            art.encoder = None
            art.encoded_columns = ()
        return art

    # batch windows
    mode, arg = window
    host_cols = ()
    wid_key = None
    if mode == "cron":
        # host-enumerated Quartz fires; per-event window ids ship as a
        # narrow int column and the device runs the ordinary batch grid
        from ..utils.cron import CronSchedule

        sched = CronSchedule.parse(str(arg))
        wid_key = f"@cron:{name}"
        host_cols = (
            HostPred(
                wid_key,
                lambda henv, _s=sched: _s.window_ids(henv["@ts"]),
                ("@ts",),
                np.int32,
            ),
        )
    batch_ts_key = None
    if mode == "externalTimeBatch":
        # same tumbling machinery as timeBatch, but stream time advances
        # with the user's timestamp attribute instead of event time
        ts_attr, dur = arg
        batch_ts_key = resolver.resolve(ts_attr).key
        mode, arg = "timeBatch", dur
    # non-aggregate projection inputs need per-cell "last event" values.
    # having may reference SELECT ALIASES (resolved later against the
    # output slots), which are not tape columns — skip them here.
    last_types_map: Dict[str, AttributeType] = {}
    for item in rewritten:
        _referenced_keys(item.expr, resolver, last_types_map)
    if having_re is not None:
        aliases = {i.alias for i in rewritten if i.alias is not None}
        for attr in ast.iter_attrs(having_re):
            if attr.name.startswith("@") or (
                attr.qualifier is None and attr.name in aliases
            ):
                continue  # slots / select aliases resolve downstream
            r = resolver.resolve(attr)
            last_types_map[r.key] = r.atype
    last_keys = sorted(last_types_map)
    art = BatchWindowArtifact(
        name=name,
        output_schema=out_schema,
        stream_code=sc,
        filter_fns=filter_fns,
        window_mode=mode,
        length=arg if mode == "lengthBatch" else None,
        time_ms=arg if mode == "timeBatch" else None,
        aggs=collector.aggs,
        arg_fns=collector.arg_fns,
        arg_types=collector.arg_types,
        code_key=code_key,
        encoder=encoder,
        last_keys=last_keys,
        last_types=[last_types_map[k] for k in last_keys],
        proj_fns=proj_fns,
        having_fn=having_fn,
        batch_slots=config.time_batch_slots,
        ts_key=batch_ts_key,
        wid_key=wid_key,
    )
    art.encoded_columns = encoded
    art.host_columns = host_cols
    return art


def _group_encoding(
    name: str,
    group_resolved: List[ResolvedAttr],
    stream_code: int,
    filter_fns: Sequence[Callable] = (),
):
    """Dense group codes for state-table artifacts. Interning keeps tables
    dense for arbitrary key distributions and multi-column keys, and
    respects the query's filters so rejected events never grow the table.
    The filters are the query's own torch closures, run here on CPU
    tensors over the host's numpy columns: interning happens while the
    tape is built, before anything reaches the device."""
    if not group_resolved:
        return None, None, ()
    encoder = GroupEncoder()
    out_key = f"@group:{name}"
    select_fn = None
    if filter_fns:
        fns = list(filter_fns)

        def select_fn(cols, _fns=fns):
            env = {k: torch.from_numpy(v) for k, v in cols.items()}
            m = torch.ones(len(next(iter(cols.values()))), dtype=torch.bool)
            for f in _fns:
                m = m & f(env)
            return m.numpy()

    enc = EncodedColumn(
        out_key=out_key,
        in_keys=tuple(r.key for r in group_resolved),
        stream_code=stream_code,
        encoder=encoder,
        select_fn=select_fn,
    )
    return out_key, encoder, (enc,)


# --------------------------------------------------------------------------
# Expired-event output: ``insert expired events into O``
# --------------------------------------------------------------------------

@dataclass
class ExpiredWindowArtifact:
    """Emit events as they LEAVE a sliding window (Siddhi's expired
    stream). Length windows expire an event when the C-th matching event
    after it arrives (emission ts = the displacing event's ts); time
    windows when stream time passes ts + span (emission ts = ts + span;
    end-of-stream flushes the remainder, the same "+inf watermark" rule
    the pattern matcher's timed absence uses). Plain projections only."""

    name: str
    output_schema: OutputSchema
    output_mode: str  # 'buffered'
    stream_code: int
    filter_fns: List
    window_mode: str  # 'length' | 'time'
    capacity: int
    time_ms: Optional[int]
    proj_fns: List
    ref_keys: List[str]  # tape columns the projections read
    ref_dtypes: Dict[str, object]  # device dtype per ref column

    def cost_info(self) -> Dict:
        """Admission-cost descriptor: each event expires exactly once
        — one expired row out per input event; retention is the window
        it leaves."""
        return {
            "name": self.name,
            "kind": "expired_window",
            "amplification": 1,
            "residency_ms": (
                int(self.time_ms)
                if self.window_mode == "time" and self.time_ms is not None
                else None
            ),
        }

    def init_state(self, device) -> Dict:
        C = self.capacity
        ring: Dict[str, torch.Tensor] = {
            "ts": torch.zeros(C, dtype=_I32, device=device),
            "count": torch.zeros((), dtype=_I32, device=device),
            "overflow": torch.zeros((), dtype=_I32, device=device),
        }
        for k in self.ref_keys:
            ring[f"c:{k}"] = torch.zeros(
                C, dtype=torch_dtype(self.ref_dtypes[k]), device=device)
        return {"enabled": torch.tensor(True, device=device), "ring": ring}

    def emit_block_width(self, tape_capacity: int, state: Dict) -> int:
        return tape_capacity + self.capacity

    def _seq_gather(self, ring_col, arr_col, P0, idx):
        """sequence[j] for the FIFO view ring[0:P0] ++ arrivals: j < P0
        reads the ring, else the arrival at j - P0."""
        C = self.capacity
        in_ring = idx < P0
        from_ring = ring_col[torch.where(in_ring, torch.clamp(idx, 0, C - 1),
                                         0).long()]
        ai = torch.clamp(idx - P0, 0, arr_col.shape[0] - 1).long()
        return torch.where(in_ring, from_ring, arr_col[ai])

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        env: ColumnEnv = dict(tape.cols)
        mask = _query_mask(self, state, tape, env)
        E = tape.capacity
        C = self.capacity
        ring = state["ring"]
        dev = mask.device
        P0 = ring["count"]
        M = mask.sum(dtype=_I32)
        rank = torch.cumsum(mask, 0, dtype=_I32) - 1
        dest = torch.where(mask, rank, E).long()

        def compact(col):
            out = torch.zeros(E + 1, dtype=col.dtype, device=dev)
            return out.scatter_(0, dest, col)[:E]

        arr_ts = compact(tape.ts)
        arr_cols = {k: compact(env[k]) for k in self.ref_keys}
        total = P0 + M
        W = C + E
        j = torch.arange(W, dtype=_I32, device=dev)
        seq_ts = self._seq_gather(ring["ts"], arr_ts, P0, j)

        if self.window_mode == "length":
            n_exp = torch.clamp(total - C, 0, W)
            # entry j is displaced by arrival j + C - P0 of this batch
            di = torch.clamp(j + C - P0, 0, E - 1).long()
            emit_ts = arr_ts[di]
        else:
            bmax = torch.where(mask, tape.ts, -(2 ** 30)).max()
            horizon = bmax - int(self.time_ms)
            # expiry over the RUNNING-MAX timestamp so the expired set is
            # always a sequence prefix — a cross-batch straggler expires
            # late instead of desyncing the emit/retain split
            mono = torch.cummax(
                torch.where(j < total, seq_ts, _I32_MAX), 0).values
            expired = (mono <= horizon) & (j < total)
            n_exp = expired.sum(dtype=_I32)
            emit_ts = seq_ts + int(self.time_ms)

        emit_env = {
            k: self._seq_gather(ring[f"c:{k}"], arr_cols[k], P0, j)
            for k in self.ref_keys
        }
        cols = tuple(as_column(p(emit_env), W, seq_ts)
                     for p in self.proj_fns)

        # survivors: sequence[total - n_keep .. total); clamp to the ring
        # (a time window can briefly hold more than C — count the drop)
        n_live = torch.clamp(total - n_exp, min=0)
        dropped = torch.clamp(n_live - C, min=0)
        n_keep = torch.clamp(n_live, max=C)
        ki = torch.arange(C, dtype=_I32, device=dev) + (total - n_keep)
        new_ring = {
            "ts": self._seq_gather(ring["ts"], arr_ts, P0, ki),
            "count": n_keep,
            "overflow": ring["overflow"] + dropped,
        }
        for k in self.ref_keys:
            new_ring[f"c:{k}"] = self._seq_gather(
                ring[f"c:{k}"], arr_cols[k], P0, ki
            )
        new_state = {"enabled": state["enabled"], "ring": new_ring}
        return new_state, (n_exp, emit_ts, cols)

    @property
    def flush_is_noop(self) -> bool:
        return self.window_mode != "time"

    def flush(self, state: Dict) -> Tuple[Dict, Tuple]:
        """End of stream: time advances past every pending deadline, so
        all retained entries expire (length windows never flush)."""
        ring = state["ring"]
        dev = ring["ts"].device
        if self.flush_is_noop:
            return state, (
                torch.zeros((), dtype=_I32, device=dev),
                torch.zeros(1, dtype=_I32, device=dev),
                tuple(torch.zeros(1, dtype=_I32, device=dev)
                      for _ in self.proj_fns),
            )
        emit_ts = ring["ts"] + int(self.time_ms)
        emit_env = {k: ring[f"c:{k}"] for k in self.ref_keys}
        cols = tuple(as_column(p(emit_env), self.capacity, emit_ts)
                     for p in self.proj_fns)
        new_ring = dict(ring)
        new_ring["count"] = torch.zeros((), dtype=_I32, device=dev)
        return (
            {"enabled": state["enabled"], "ring": new_ring},
            (ring["count"], emit_ts, cols),
        )


def compile_expired_window(
    q: ast.Query,
    name: str,
    schemas,
    stream_codes: Dict[str, int],
    extensions,
    config=None,
):
    from .config import DEFAULT_CONFIG

    config = config or DEFAULT_CONFIG
    assert q.output_events == "expired", q.output_events
    inp = q.input
    if not isinstance(inp, ast.StreamInput) or not inp.windows:
        raise SiddhiQLError(
            "'insert expired events into' needs a windowed single-stream "
            "input (only windows retain events to expire)"
        )
    if q.selector.group_by or q.selector.having is not None or any(
        ast.contains_aggregate(i.expr) for i in q.selector.items
    ):
        raise SiddhiQLError(
            "aggregations/group by/having over the expired stream are "
            "not supported; select plain attributes"
        )
    window = _window_of(inp)
    if window[0] not in ("length", "time"):
        raise SiddhiQLError(
            f"expired-events output supports #window.length and "
            f"#window.time (got #window.{window[0]})"
        )
    resolver = _stream_scope(q, schemas)
    filter_fns = _filters(inp, resolver, extensions)
    proj_fns: List = []
    out_fields: List[OutputField] = []
    ref_keys: List[str] = []
    ref_dtypes: Dict[str, object] = {}
    for item in _select_items(q, schemas):
        ce = compile_expr(item.expr, resolver, extensions)
        proj_fns.append(ce.fn)
        out_fields.append(
            OutputField(item.output_name(), ce.atype, ce.table)
        )
        for a in ast.iter_attrs(item.expr):
            r = resolver.resolve(a)
            if r.key not in ref_keys:
                ref_keys.append(r.key)
                ref_dtypes[r.key] = r.atype.device_dtype
    mode, arg = window
    cap = arg if mode == "length" else config.time_window_capacity
    art = ExpiredWindowArtifact(
        name=name,
        output_schema=OutputSchema(q.output_stream, tuple(out_fields)),
        output_mode="buffered",
        stream_code=stream_codes[inp.stream_id],
        filter_fns=filter_fns,
        window_mode=mode,
        capacity=int(cap),
        time_ms=arg if mode == "time" else None,
        proj_fns=proj_fns,
        ref_keys=ref_keys,
        ref_dtypes=ref_dtypes,
    )
    art.encoded_columns = ()
    return art


# --------------------------------------------------------------------------
# Per-key sliding windows: ``partition with (k of S) begin ...#window.length``
# --------------------------------------------------------------------------

@dataclass
class PerKeyWindowArtifact:
    """``partition with (k of S) ... #window.length(C)``: every key has a
    window of its own last C matching events (Siddhi's per-partition
    instance, not a group-by over one shared window).

    A key's window sum at its n-th arrival is ``S_k(n) - S_k(n - C)``,
    ``S_k`` the key's compensated (Neumaier) running sum. State: a ``[G]``
    arrival count, the running sums ``S_*`` with their compensation
    ``kc_*``, and a ``[G, C]`` ring ``ring_*`` of each key's last C prefix
    checkpoints (slot ``n mod C``). A batch is one stable sort by key,
    segmented scans, two gathers and the ring write of each key's last
    ``min(C, arrivals)`` checkpoints: no loop over events and no host
    read. ``G`` buckets with the key encoder (``grow_state``)."""

    name: str
    output_schema: OutputSchema
    stream_code: int
    filter_fns: List
    capacity: int  # C: a key's window length
    aggs: List[_Agg]
    arg_fns: List[Callable]
    arg_types: List[AttributeType]
    code_key: str
    encoder: GroupEncoder
    proj_fns: List
    having_fn: Optional[Callable]
    output_mode: str = "aligned"

    def cost_info(self) -> Dict:
        """Admission-cost descriptor: per-key count-evicted windows —
        one row per event; state grows with key cardinality (bucketed
        [G, C] re-buckets as keys intern)."""
        return {
            "name": self.name,
            "kind": "perkey_window",
            "amplification": 1,
            "residency_ms": None,
            "grows_with": "keys",
        }

    def __post_init__(self):
        if any(s not in ("sum", "sumsq")
               for stats in self._stats().values() for s in stats):
            raise SiddhiQLError(
                "per-partition windows support sum/count/avg/stddev "
                "aggregates (min/max need the window matrix; group by "
                "outside the partition instead)"
            )

    def _stats(self) -> Dict[int, set]:
        return _acc_stats_for(self.aggs)

    def _G(self) -> int:
        return _bucket(len(self.encoder), MIN_GROUP_CAPACITY)

    def init_state(self, device) -> Dict:
        G, C = self._G(), self.capacity
        st = {"enabled": torch.tensor(True, device=device),
              "cnt": torch.zeros(G, dtype=_I32, device=device)}
        for arg_idx, stats in self._stats().items():
            for s in stats:
                for key, shape in ((f"S_{s}{arg_idx}", (G,)),
                                   (f"kc_{s}{arg_idx}", (G,)),
                                   (f"ring_{s}{arg_idx}", (G, C))):
                    st[key] = torch.zeros(shape, dtype=torch.float32,
                                          device=device)
        return st

    def grow_state(self, state: Dict) -> Dict:
        G, need = int(state["cnt"].shape[0]), self._G()
        if need <= G:
            return state
        out = dict(state)
        for k, v in state.items():
            if k != "enabled":
                out[k] = torch.cat([v, v.new_zeros((need - G,)
                                                   + tuple(v.shape[1:]))])
        return out

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        env: ColumnEnv = dict(tape.cols)
        mask = _query_mask(self, state, tape, env)
        E, C = tape.capacity, self.capacity
        G = int(state["cnt"].shape[0])
        dev = mask.device

        segkey = torch.where(mask, env[self.code_key].to(_I32), G).long()
        g_s, order = torch.sort(segkey, stable=True)  # keys contiguous
        inv = _inverse(order)
        flags = torch.ones(E, dtype=torch.bool, device=dev)
        flags[1:] = g_s[1:] != g_s[:-1]
        ends = torch.ones_like(flags)
        ends[:-1] = flags[1:]
        gather_g = torch.clamp(g_s, max=G - 1)
        mask_s = mask[order]

        ones = torch.ones(E, dtype=_I32, device=dev)
        seg_rank = _seg_scan(flags, ones, torch.add) - 1  # 0-based, local
        local_n = state["cnt"][gather_g] + seg_rank  # the key's ordinal
        pos = torch.arange(E, device=dev)
        new_state = dict(state)
        new_state["cnt"] = state["cnt"] + _segment_reduce(
            mask.to(_I32), segkey, G, "sum")
        # the windowed count has a closed form
        stats_env: Dict[str, torch.Tensor] = {
            "cnt": torch.clamp(local_n + 1, max=C)[inv]}
        # each key's arrivals this batch, and its last min(C, arrivals)
        seg_len = _segment_reduce(mask_s.to(_I32),
                                  torch.where(mask_s, gather_g, G), G, "sum")
        is_tail = mask_s & (seg_rank >= seg_len[gather_g] - C)
        widx = torch.where(is_tail, gather_g * C + torch.remainder(
            local_n, C), G * C)
        slot = torch.remainder(torch.clamp(local_n - C, min=0), C)
        in_batch = seg_rank >= C
        gi = torch.where(ends & (g_s < G), g_s, G)

        for arg_idx, stats in self._stats().items():
            v = as_column(self.arg_fns[arg_idx](env), E, tape.ts)
            v_s = torch.where(mask_s, v[order].to(torch.float32), 0.0)
            for s in stats:
                vals = v_s * v_s if s == "sumsq" else v_s
                skey, kckey, rkey = (f"S_{s}{arg_idx}", f"kc_{s}{arg_idx}",
                                     f"ring_{s}{arg_idx}")
                acc, kc, ring = state[skey], state[kckey], state[rkey]
                base = (acc + kc)[gather_g]
                p_scan, c_scan = _seg_scan_sum_kahan(flags, vals)
                pref = p_scan + c_scan
                s_at = base + pref  # S_k(n), inclusive
                # S_k(n - C): in this batch's run when seg_rank >= C, else
                # the ring's checkpoint, else 0
                prev_batch = pref[torch.clamp(pos - C, min=0)] + base
                prev_ring = ring[gather_g, slot.long()]
                s_prev = torch.where(
                    in_batch, prev_batch,
                    torch.where(local_n >= C, prev_ring, 0.0))
                stats_env[f"{s}{arg_idx}"] = (s_at - s_prev)[inv]
                # the ring: slot n mod C of each key's tail (distinct
                # slots); the rest to a dump slot, sliced off
                flat = torch.cat([ring.reshape(G * C), ring.new_zeros(1)])
                flat.index_put_((widx,), s_at)
                new_state[rkey] = flat[:G * C].reshape(G, C)
                # the batch's totals into the running sums (two-sum)
                tot = torch.zeros(G + 1, dtype=torch.float32, device=dev)
                tot.index_put_((gi,), torch.where(ends, p_scan, 0.0))
                tot_c = torch.zeros_like(tot)
                tot_c.index_put_((gi,), torch.where(ends, c_scan, 0.0))
                tot, tot_c = tot[:G], tot_c[:G]
                t = acc + tot
                err = torch.where(acc.abs() >= tot.abs(),
                                  (acc - t) + tot, (tot - t) + acc)
                new_state[skey] = t
                new_state[kckey] = kc + err + tot_c

        for agg in self.aggs:
            env[agg.slot] = _agg_from_stats(agg, stats_env).to(
                _dt(agg.out_type))
        cols, out_mask = _project(self, env, E, tape.ts, mask)
        return new_state, (out_mask, tape.ts, cols)


def window_wire_opts(artifact: SlidingWindowArtifact, config):
    """Wire option for sort-path sliding windows: select items that are
    PLAIN references to group-by columns emit the @group CODE (which
    already travels for the grouping) and decode back through the encoder
    — the raw group column drops off the wire entirely. Returns
    (needed_device_columns, ()) or None."""
    if not config.lazy_projection:
        # this IS late materialization (values resolve host-side at
        # decode): the same opt-in as the select/chain wire options
        return None
    if not artifact._blocked() or artifact.code_key is None:
        return None
    if artifact.having_fn is not None:
        return None  # having may read the coded output alias
    if not artifact.proj_srcs:
        return None
    gkeys = tuple(artifact.group_keys_)
    gcp = tuple(
        gkeys.index(src) if src is not None and src in gkeys else None
        for src in artifact.proj_srcs
    )
    if all(g is None for g in gcp):
        return None
    needed = set(artifact.filter_keys)
    if artifact.ts_key is not None:
        needed.add(artifact.ts_key)
    for refs, gi in zip(artifact.proj_refs, gcp):
        if gi is None:
            needed |= set(refs)
    artifact.group_code_proj = gcp
    return needed, ()


def compile_delay_window(
    q: ast.Query,
    name: str,
    schemas,
    stream_codes: Dict[str, int],
    extensions,
    config=None,
):
    """``#window.delay(t)``: pass events through t ms late. Identical
    emission schedule to a time window's expired stream (entry ts +
    span), so it IS an ExpiredWindowArtifact with a rewritten window."""
    inp = q.input
    if q.selector.group_by or q.selector.having is not None or any(
        ast.contains_aggregate(i.expr) for i in q.selector.items
    ):
        raise SiddhiQLError(
            "aggregations over #window.delay are not supported; delay "
            "the aggregated stream instead (chain the queries)"
        )
    delay_ms = _window_of(inp)[1]
    rewritten_inp = dataclasses.replace(
        inp, windows=(ast.Window("time", (ast.TimeLiteral(delay_ms),)),)
    )
    q2 = dataclasses.replace(
        q, input=rewritten_inp, output_events="expired"
    )
    return compile_expired_window(
        q2, name, schemas, stream_codes, extensions, config
    )
