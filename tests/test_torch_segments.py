"""Segments of the torch port: device scalars on the wire, the segment
helpers, capture safety, and the resident replay over segments.

A CUDA graph replays the launches it captured with the arguments it
captured, so a segment's steps may read no tape or state value on the
host: every per-tape scalar travels as the int32 leaf ``scalars``, and a
step that must read a device value (a chain matcher whose host-known bound
exceeds its compact width) is not captured. Here, on the CPU:

- ``WireTape.expand`` of a tape with device scalars is bit-equal to the
  host-scalar expansion (the numpy formula the port used before) and to
  the JAX package's, for every timestamp kind (d0, d8, d16, i32), also
  through a stacked segment's views and for a padding tape;
- ``wire_sig``/``stack_wires``/``empty_wire_like`` agree with the
  reference's ``_wire_sig``/``_stack_wires``/``_empty_wire_like`` on which
  tapes stack, over tapes whose widths widen;
- a segment body run under a guard that raises on any host read of a
  tensor derived from the tapes or the states (``item``, ``tolist``,
  ``__bool__``, ``__int__``, ``__float__``, ``__index__``, ``nonzero``,
  ``numpy``, boolean-mask indexing, data-dependent shapes) passes for every
  bench config under the bench's settings and raises for the
  default-settings headline (the CPU stand-in for capture safety);
- the resident replay: ``rerun()`` after the in-place reset gives the
  same counts as ``run()`` on the same tensors; table growth mid-stream
  (the quote board, fused) gives the reference's rows; ``eager_segments``
  is 0 under the bench's settings and counts the default headline's.
"""

import operator
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import bench
from flink_siddhi_tpu.runtime import executor as jax_executor
from flink_siddhi_tpu.runtime import tape as jax_tape
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.runtime import segment, tape as torch_tape
from flink_siddhi_tpu_torch.runtime.graphs import step_segment

from test_torch_fused import _columns, _job

torch.set_num_threads(2)

_TFIELDS = [("price", "double"), ("small", "int"), ("timestamp", "long")]


def _ts_stream(n, seed, step=1, jitter=0, ts0=1000, small_hi=50):
    rng = np.random.default_rng(seed)
    ts = ts0 + step * np.arange(n, dtype=np.int64)
    if jitter:
        ts = np.sort(ts + rng.integers(0, jitter, n))
    return {"price": rng.random(n) * 100.0,
            "small": rng.integers(0, small_hi, n).astype(np.int32),
            "timestamp": ts}


def _wires(pkg, tapes, capacity=8192):
    """The wire tapes of ``tapes`` (column dicts), sticky widths carried."""
    Schema, Batch, mod = ((JaxSchema, JaxBatch, jax_tape) if pkg == "jax"
                          else (fpt.StreamSchema, fpt.EventBatch, torch_tape))
    schema = Schema(_TFIELDS)
    cols = tuple(f"A.{f}" for f, _ in _TFIELDS)
    spec = mod.TapeSpec({"A": 0}, cols,
                        {f"A.{f}": t for f, t in zip(schema.field_names,
                                                      schema.field_types)})
    sticky = {}
    return [
        mod.build_wire_tape(spec, [Batch("A", schema, c, c["timestamp"])],
                            1000, sticky, capacity=capacity)[0]
        for c in tapes
    ]


def _host_scalar_ts(w):
    """The host-scalar expansion of a wire tape's timestamps and validity
    (n_valid and ts_base read on the host), as numpy."""
    cap = w.capacity
    n = int(w.n_valid[0])
    iota = np.arange(cap, dtype=np.int32)
    with np.errstate(over="ignore"):
        if w.ts_kind == "i32":
            ts = np.asarray(w.ts, np.int32)
        elif w.ts_kind == "d0":
            base, step = int(w.ts_base[0]), int(w.ts_base[1])
            ts = (np.int32(base)
                  + np.int32(step) * np.minimum(iota, max(n - 1, 0))
                  ).astype(np.int32)
        else:
            ts = (np.int32(w.ts_base[0])
                  + np.cumsum(np.asarray(w.ts, np.int32), dtype=np.int32))
    return ts, iota < n


@pytest.mark.parametrize("case,want", [
    ({"n": 8192, "step": 1}, "d0"),
    ({"n": 3000, "step": 2, "jitter": 100}, "d8"),
    ({"n": 3000, "step": 200, "jitter": 20_000}, "d16"),
    ({"n": 3000, "step": 40_000, "jitter": 5}, "i32"),
])
def test_device_scalar_expand_is_bit_equal(case, want):
    n = case.pop("n")
    cols = _ts_stream(n, 5, **case)
    (tw,), (jw,) = _wires("torch", [cols]), _wires("jax", [cols])
    assert tw.ts_kind == jw.ts_kind == want
    ref_ts, ref_valid = _host_scalar_ts(tw)
    jref = jax.tree.map(np.asarray, jax.tree.map(jnp.asarray, jw).expand())
    pad = segment.empty_wire_like(tw)
    pad_ts, pad_valid = _host_scalar_ts(pad)
    seg = segment.stack_wires([tw, pad])
    for w, (ts, valid) in (
        (tw.to(torch.device("cpu")), (ref_ts, ref_valid)),
        (seg.tapes()[0], (ref_ts, ref_valid)),
        (seg.tapes()[1], (pad_ts, pad_valid)),
    ):
        got = w.expand()
        assert got.ts.dtype == torch.int32 and got.valid.dtype == torch.bool
        assert np.array_equal(got.ts.numpy(), ts)
        assert np.array_equal(got.valid.numpy(), valid)
    got = seg.tapes()[0].expand()
    assert np.array_equal(got.ts.numpy(), jref.ts)
    assert np.array_equal(got.valid.numpy(), jref.valid)
    for k in jref.cols:
        assert got.cols[k].numpy().tobytes() == jref.cols[k].tobytes(), k
    assert not pad_valid.any() and int(pad.scalars[0]) == 0


def test_segment_helpers_stack_what_the_reference_stacks():
    # widths widen across the tapes (small: i8 -> i16; ts: d0 -> d8 ->
    # d16), with equal neighbours between the breaks
    specs = [dict(step=1), dict(step=1), dict(step=1, small_hi=1000),
             dict(step=1, small_hi=1000), dict(step=2, jitter=50),
             dict(step=2, jitter=50), dict(step=200, jitter=20_000)]
    tapes, ts0 = [], 1000
    for i, kw in enumerate(specs):
        c = _ts_stream(4096, i, ts0=ts0, **kw)
        ts0 = int(c["timestamp"][-1]) + 1
        tapes.append(c)
    tw, jw = _wires("torch", tapes), _wires("jax", tapes)
    tsig = [segment.wire_sig(w) for w in tw]
    jsig = [jax_executor._wire_sig(w) for w in jw]
    same_t = [[a == b for b in tsig] for a in tsig]
    same_j = [[a == b for b in jsig] for a in jsig]
    assert same_t == same_j
    assert 1 < len(set(tsig)) < len(tsig)  # some stack, some break
    # a stacked run of equal tapes round-trips through its buffer, its
    # padding tape is the reference's
    run = [w for w, s in zip(tw, tsig) if s == tsig[0]]
    jrun = [w for w, s in zip(jw, jsig) if s == jsig[0]]
    seg = segment.stack_wires(segment.pad_segment(run, 4))
    jseg = jax_executor._stack_wires(
        jrun + [jax_executor._empty_wire_like(jrun[-1])] * (4 - len(jrun))
    )
    assert len(seg) == 4 and seg.n_valid == [4096, 4096, 0, 0]
    assert seg.nbytes % 16 == 0
    for i, t in enumerate(seg.tapes()):
        ref = jax.tree.map(lambda x: np.asarray(x)[i], jseg)
        for a, b in ((t.ts, ref.ts), (t.scalars[0:1], ref.n_valid)):
            assert np.array_equal(a.numpy(), np.asarray(b))
        for k in ref.cols:
            assert t.cols[k].numpy().tobytes() == ref.cols[k].tobytes()
    with pytest.raises(ValueError, match="structure"):
        segment.stack_wires([tw[0], tw[-1]])


# --------------------------------------------------------------------------
# Capture safety on the CPU: a guard against host reads
# --------------------------------------------------------------------------

class HostRead(AssertionError):
    pass


_READS = {"item", "tolist", "__bool__", "__int__", "__float__",
          "__index__", "nonzero", "argwhere", "numpy", "masked_select",
          "unique", "unique_consecutive", "bincount", "__array__"}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


class HostReadGuard(TorchFunctionMode):
    """Raises ``HostRead`` on any host read of a tensor derived from the
    ``roots`` (the tapes and the states): the reads a CUDA graph cannot
    capture. A tensor is derived when an op read a derived tensor to make
    it (in-place ops taint their target). Host reads of constants made at
    compile time (a literal's 0-d CPU tensor) are allowed, as a capture
    bakes them in."""

    def __init__(self, roots):
        super().__init__()
        self.taint = {}
        for t in _tensors(roots):
            self._mark(t)

    def _mark(self, t):
        self.taint[id(t)] = weakref.ref(t)

    def _derived(self, t):
        ref = self.taint.get(id(t))
        return ref is not None and ref() is t

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = list(_tensors((args, kwargs)))
        derived = any(self._derived(t) for t in ins)
        name = getattr(func, "__name__", str(func))
        if derived and name in _READS:
            raise HostRead(name)
        if derived and name == "where" and len(args) + len(kwargs) == 1:
            raise HostRead("where(cond)")
        if name == "__getitem__" and derived and any(
            t.dtype == torch.bool for t in _tensors(args[1:])
        ):
            raise HostRead("boolean mask indexing")
        out = func(*args, **kwargs)
        if derived:
            for t in _tensors(out):
                self._mark(t)
            if name.endswith("_") and args:
                for t in _tensors(args[0]):
                    self._mark(t)
        return out


def test_guard_catches_host_reads():
    x = torch.arange(6)
    c = torch.tensor(3)  # a compile-time constant
    with HostReadGuard([x]):
        assert int(c) == 3 and c.item() == 3
        y = (x + 1).cumsum(0)
        for read in (lambda: y.item(), lambda: bool(y[0]),
                     lambda: y[y > 2], lambda: y.nonzero(),
                     lambda: operator.index(y[1]), lambda: y.tolist()):
            with pytest.raises(HostRead):
                read()


def _staged(config, engine=None, n_batches=4):
    """A staged resident replay of ``config`` over the bench's stream (on
    the CPU), with its runtime."""
    cql = bench._config_cql(config)
    data = _columns(1000 if config == "window_groupby" else 50,
                    n_batches=n_batches)
    job = _job("torch", cql, data, None,
               config=dict(lazy_projection=True, pred_pushdown=True)
               if engine is None else engine, retain=False)
    rep = fpt.ResidentReplay(job)
    rep.stage()
    return rep, job._plans["p"]


@pytest.mark.parametrize("config", ["filter", "headline", "multiquery64",
                                    "pattern2", "window_groupby"])
def test_segment_body_makes_no_host_read(config):
    rep, rt = _staged(config)
    (seg, *_), = rep.segments.values()
    tapes = seg.tapes()
    with HostReadGuard([[t.arrays() for t in tapes], rt.states, rt.acc]):
        states, acc = step_segment(rt.plan, rt.states, rt.acc, tapes)
    assert int(acc["meta"][0].sum()) > 0
    assert rep.job.eager_segments == 0


def test_default_settings_headline_body_reads_its_count():
    rep, rt = _staged("headline", engine={})
    (seg, *_), = rep.segments.values()
    tapes = seg.tapes()
    with pytest.raises(HostRead):
        with HostReadGuard([[t.arrays() for t in tapes], rt.states,
                            rt.acc]):
            step_segment(rt.plan, rt.states, rt.acc, tapes)


# --------------------------------------------------------------------------
# The resident replay over segments
# --------------------------------------------------------------------------

@pytest.mark.parametrize("config", ["headline", "window_groupby"])
def test_rerun_resets_the_bound_tensors_in_place(config):
    rep, rt = _staged(config, n_batches=6)
    job = rep.job
    rep.run()
    job.flush()
    first = dict(job.emitted_counts)
    assert sum(first.values()) > 0
    # the bound states, and the accumulator ring (the live accumulator is
    # one of its positions)
    bound = [t for _, t in _flat(rt.states)]
    ring = [t for acc in rt.ring for t in acc.values()]
    assert len(rt.ring) == len(rep.segments["p"]) + 1
    for i in range(2):
        rep.rerun()
        assert {k: v // (i + 2) for k, v in job.emitted_counts.items()} \
            == first
        assert all(v % (i + 2) == 0 for v in job.emitted_counts.values())
        now = [t for _, t in _flat(rt.states)]
        assert all(a is b for a, b in zip(now, bound))
        assert [t for acc in rt.ring for t in acc.values()] == ring
        assert rt.acc is rt.ring[rt.acc_pos] and not rt.drain_q
    assert job.eager_segments == 0


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flat(tree[k], f"{path}.{k}")]
    return [(path, tree)]


def test_default_settings_headline_counts_eager_resident_segments():
    rep, rt = _staged("headline", engine={}, n_batches=6)
    rep.run()
    rep.job.flush()
    n_segs = len(rep.segments["p"])
    assert rep.job.eager_segments == n_segs >= 1
    assert rep.job.host_syncs == rep.job.drain_waits + 6
    assert rep.job.fetch_syncs == rep.job.drain_fetches > 0


_QFIELDS = [("symbol", "string"), ("price", "double"), ("volume", "long")]
QUOTE_BOARD = (
    "from StockStream#window.unique(symbol) "
    "select symbol, count() as symbols, sum(price * volume) as notional, "
    "avg(price) as avg_price, min(price) as lo, max(price) as hi "
    "insert into Board"
)


def _quote_job(pkg, data, seg):
    from test_torch_fused import _PKGS

    Schema, Batch, Source, compile_plan, Job, _Config, kw = _PKGS[pkg]
    schema = Schema(_QFIELDS)
    table = schema.string_tables["symbol"]
    n_sym = int(data["symbol"].max()) + 1
    codes = np.array([table.intern(f"S{i:05d}") for i in range(n_sym)],
                     np.int32)
    batches = [
        Batch("StockStream", schema,
              {"symbol": codes[data["symbol"][s:s + 1024]],
               "price": data["price"][s:s + 1024],
               "volume": data["volume"][s:s + 1024]},
              data["ts"][s:s + 1024])
        for s in range(0, len(data["ts"]), 1024)
    ]
    plan = compile_plan(QUOTE_BOARD, {"StockStream": schema}, plan_id="p")
    job = Job([plan], [Source("StockStream", schema, iter(batches))],
              batch_size=1024, time_mode="processing", **kw)
    job.fused_segment_len = seg
    job.drain_interval_ms = 1e9
    job.run()
    return job.results_with_ts("Board"), job


def test_table_growth_mid_stream_matches_jax_fused():
    # new symbols keep arriving: the unique window's table grows past its
    # first buckets between segments (grow_state once a segment), so the
    # state signature, and with it the binding, changes mid-stream
    rng = np.random.default_rng(21)
    n = 8 * 1024
    sym = np.minimum(np.arange(n) // 16 + rng.integers(0, 8, n), 600)
    data = {"symbol": sym, "price": np.round(rng.uniform(1, 500, n), 2),
            "volume": rng.integers(1, 10_001, n),
            "ts": 1000 + np.arange(n, dtype=np.int64)}
    ref, _ = _quote_job("jax", data, 4)
    got, job = _quote_job("torch", data, 4)
    per_batch, _ = _quote_job("torch", data, None)
    assert got == per_batch
    assert len(got) == len(ref) == n
    assert [t for t, _ in got] == [t for t, _ in ref]
    for i in (0, 1, 4, 5):
        assert [r[i] for _, r in got] == [r[i] for _, r in ref], i
    for i in (2, 3):
        assert np.allclose([r[i] for _, r in got], [r[i] for _, r in ref])
    rt = job._plans["p"]
    assert int(rt.states["query_0"]["valid"].shape[0]) > 128
    # the symbols' group codes pass 127 in batch 2: their wire width
    # widens from int8 to int16 there (a structural break), so the
    # segments hold 2, 4 and 2 tapes
    assert "i16" in dict(rt.wire_kinds).values()
    assert job._fused_k(rt) == 4 and job.fusion_dispatches == 3
