"""The torch port's narrow wire tape and host predicates, against the JAX
package.

Each test builds the same batches (numpy, from a seed) and the same tape
spec in both packages, builds wire tapes with each package's
``build_wire_tape`` and requires equal kinds and bit-equal host arrays;
then expands both — the reference's ``WireTape.expand`` under JAX on the
CPU, the port's with torch on the CPU — and requires the same logical tape
exactly (no tolerance: expansion is integer and bit arithmetic and float
copies). The host predicate compiler (``compile_host_pred``, a numpy copy
in each package) must give the same masks and read the same columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_siddhi_tpu.compiler.expr import ExprResolver as JaxResolver
from flink_siddhi_tpu.compiler.expr import compile_host_pred as jax_hpred
from flink_siddhi_tpu.query import parse_plan as jax_parse
from flink_siddhi_tpu.runtime import tape as jtape
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler.expr import ExprResolver, compile_host_pred
from flink_siddhi_tpu_torch.query import parse_plan
from flink_siddhi_tpu_torch.runtime import tape as ttape

torch.set_num_threads(2)

_FIELDS = [("small", "int"), ("wide", "int"), ("big", "int"),
           ("price", "double"), ("ratio", "float"), ("flag", "bool"),
           ("name", "string"), ("timestamp", "long")]
_PKGS = {
    "jax": (JaxSchema, JaxBatch, jtape),
    "torch": (fpt.StreamSchema, fpt.EventBatch, ttape),
}


def _gen(seed, n, ts0=1000, step=1, jitter=0, small_hi=100, wide_hi=30_000):
    """One stream's columns: ``small`` in [-small_hi, small_hi), ``wide``
    in [-wide_hi, wide_hi), ``big`` over the int32 range, f64 prices,
    f32 ratios, bools, three names, and timestamps ts0 + step*i plus a
    sorted jitter of up to ``jitter`` ms per event."""
    rng = np.random.default_rng(seed)
    deltas = np.full(n, step, np.int64)
    if jitter:
        deltas += rng.integers(0, jitter + 1, n)
    deltas[0] = 0
    ts = ts0 + np.cumsum(deltas)
    return {
        "small": rng.integers(-small_hi, small_hi, n).astype(np.int32),
        "wide": rng.integers(-wide_hi, wide_hi, n).astype(np.int32),
        "big": rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32),
        "price": rng.random(n) * 100.0,
        "ratio": rng.random(n).astype(np.float32),
        "flag": rng.random(n) < 0.3,
        "name": rng.integers(0, 3, n).astype(np.int32),
        "timestamp": ts,
    }


def _hp_fns(pkg):
    """Host predicates of the spec: two masks, over a DOUBLE and an INT
    column."""
    Schema, _, tape = _PKGS[pkg]
    return (
        tape.HostPred("@p:0", lambda env: env["A.price"] > 50.0,
                      ("A.price",)),
        tape.HostPred("@p:1", lambda env: env["A.small"] % 7 == 0,
                      ("A.small",)),
    )


def _spec(pkg, streams, device_columns=None, host_preds=False):
    Schema, _, tape = _PKGS[pkg]
    schema = Schema(_FIELDS)
    codes = {sid: i for i, sid in enumerate(streams)}
    cols, types = [], {}
    for sid in streams:
        for fname, ftype in zip(schema.field_names, schema.field_types):
            cols.append(f"{sid}.{fname}")
            types[f"{sid}.{fname}"] = ftype
    spec = tape.TapeSpec(
        codes, tuple(cols), types,
        device_columns=device_columns,
        host_preds=_hp_fns(pkg) if host_preds else (),
    )
    return schema, spec


def _batches(pkg, schema, per_stream):
    """Event time is the ``timestamp`` column unless ``_ts`` gives it."""
    _, Batch, _ = _PKGS[pkg]
    return [Batch(sid, schema, {k: v for k, v in c.items() if k != "_ts"},
                  c.get("_ts", c["timestamp"]))
            for sid, c in per_stream]


def _jax_expand(wire):
    w = jax.tree.map(jnp.asarray, wire)
    return jax.tree.map(np.asarray, w.expand())


def _check_pair(jw, tw):
    """Equal structure and bit-equal host arrays."""
    assert tw.kinds == jw.kinds
    assert tw.ts_kind == jw.ts_kind
    assert (tw.stream_const, tw.epoch_i32, tw.cap) == (
        jw.stream_const, jw.epoch_i32, jw.cap)
    for a, b in ((jw.ts, tw.ts), (jw.n_valid, tw.n_valid),
                 (jw.ts_base, tw.ts_base), (jw.stream, tw.stream)):
        if a is None or b is None:
            assert a is None and b is None
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sorted(jw.cols) == sorted(tw.cols)
    for k in jw.cols:
        a, b = jw.cols[k], tw.cols[k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def _check_expand(jw, tw):
    ref = _jax_expand(jw)
    got = tw.to(torch.device("cpu")).expand()
    for name in ("ts", "stream", "valid"):
        r, g = getattr(ref, name), getattr(got, name).numpy()
        assert r.dtype == g.dtype and np.array_equal(r, g), name
    assert sorted(ref.cols) == sorted(got.cols)
    for k in ref.cols:
        r, g = ref.cols[k], got.cols[k].numpy()
        assert r.dtype == g.dtype and r.tobytes() == g.tobytes(), k


def _build_both(streams, tapes, epoch, capacity=None, **spec_kw):
    """Build the wire tapes of ``tapes`` (each a list of (stream, columns))
    in order with both packages, sticky kinds carried; check every pair
    and its expansion. Returns the torch wires."""
    specs = {p: _spec(p, streams, **spec_kw) for p in _PKGS}
    sticky = {p: {} for p in _PKGS}
    out = []
    for per_stream in tapes:
        wires = {}
        for p, (schema, spec) in specs.items():
            wires[p] = _PKGS[p][2].build_wire_tape(
                spec, _batches(p, schema, per_stream), epoch, sticky[p],
                capacity=capacity,
            )[0]
        _check_pair(wires["jax"], wires["torch"])
        _check_expand(wires["jax"], wires["torch"])
        out.append(wires["torch"])
    assert sticky["jax"] == sticky["torch"]
    return out


@pytest.mark.parametrize("ts_case,want", [
    ({"n": 8192, "step": 1}, "d0"),  # constant cadence, >= 4,096 events
    ({"n": 1000, "step": 1}, "d8"),  # constant, but too short for d0
    ({"n": 3000, "step": 2, "jitter": 100}, "d8"),
    ({"n": 3000, "step": 200, "jitter": 20_000}, "d16"),
    ({"n": 3000, "step": 1, "jitter": 70_000}, "i32"),
])
def test_every_column_and_ts_kind_matches_jax(ts_case, want):
    n = ts_case.pop("n")
    cols = _gen(1, n, **ts_case)
    # a LONG column equal to the event time ships as an alias (0 bytes)
    (tw,) = _build_both(["A"], [[("A", cols)]], epoch=1000,
                        host_preds=True)
    kinds = dict(tw.kinds)
    assert tw.ts_kind == want
    assert kinds == {
        "@p:0": "b1", "@p:1": "b1", "A.big": "i32", "A.flag": "b1",
        "A.name": "i8", "A.price": "f32", "A.ratio": "f32",
        "A.small": "i8", "A.timestamp": "alias_ts", "A.wide": "i16",
    }


def test_sticky_widths_widen_across_three_tapes():
    # small: i8 -> i16 -> (i8 data) stays i16; timestamp: alias, then a
    # batch where it is not the event time degrades to its measured width
    # (i16) and stays there; ts: d0 -> d8 (jitter) -> constant again: d8
    t1 = _gen(2, 5000)
    t2 = _gen(3, 5000, ts0=int(t1["timestamp"][-1]) + 1, jitter=5,
              small_hi=1000)
    t2["_ts"] = t2["timestamp"]
    t2["timestamp"] = t2["timestamp"] + 7  # no longer the event time
    t3 = _gen(4, 5000, ts0=int(t2["timestamp"][-1]) + 1)
    wires = _build_both(["A"], [[("A", t)] for t in (t1, t2, t3)],
                        epoch=1000, capacity=8192)
    kinds = [dict(w.kinds) for w in wires]
    assert [k["A.small"] for k in kinds] == ["i8", "i16", "i16"]
    assert [k["A.timestamp"] for k in kinds] == ["alias_ts", "i16", "i16"]
    assert [w.ts_kind for w in wires] == ["d0", "d8", "d8"]


def test_negative_epoch_i32_alias_wraps_like_jax():
    # a real wall-clock epoch in ms: its low 32 bits have bit 31 set, so
    # the int32 epoch is negative and ts + epoch_i32 wraps
    epoch = 1_700_000_000_000
    assert (epoch & 0xFFFFFFFF) >= 1 << 31
    cols = _gen(5, 6000, ts0=epoch)
    (tw,) = _build_both(["A"], [[("A", cols)]], epoch=epoch)
    assert tw.epoch_i32 < 0
    assert dict(tw.kinds)["A.timestamp"] == "alias_ts"
    got = tw.to(torch.device("cpu")).expand()
    ts64 = cols["timestamp"]
    wrapped = ((ts64 + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    assert np.array_equal(got.cols["A.timestamp"][:6000].numpy(), wrapped)


def test_two_streams_and_capacity_padding_match_jax():
    a = _gen(6, 700, ts0=1000, jitter=3)
    b = _gen(7, 500, ts0=1001, jitter=4)
    b["flag"][:] = False
    (tw,) = _build_both(["A", "B"], [[("A", a), ("B", b)]], epoch=1000,
                        capacity=2048, host_preds=True)
    assert tw.stream is not None and tw.stream.dtype == np.int8
    got = tw.to(torch.device("cpu")).expand()
    assert got.capacity == 2048
    assert int(got.valid.sum()) == 1200
    assert (got.stream[1200:] == -1).all()
    # padding repeats the last valid timestamp
    assert (got.ts[1200:] == got.ts[1199]).all()


def test_device_columns_prune_the_wire():
    cols = _gen(8, 4096)
    (tw,) = _build_both(["A"], [[("A", cols)]], epoch=1000,
                        device_columns=("A.small",), host_preds=True)
    assert sorted(tw.cols) == ["@p:0", "@p:1", "A.small"]


_PREDS = [
    "small == 2", "small != 2 and price > 50.0", "not (small < 5)",
    "price >= 25.5 or ratio < 0.25", "name == 'beta'", "'gamma' == name",
    "name != 'alpha'", "flag == true", "small * 2 + 1 > 7",
    "price / 2 < 10.0", "small % 3 == 0", "wide / 7 > 100",
    "-price < -10.0", "timestamp > 1000 + 2 sec", "price > 50.000001",
    "big - wide > 0",
]


def _host_env(cols, sid="S"):
    return {f"{sid}.{k}": v for k, v in cols.items()}


@pytest.mark.parametrize("pred", _PREDS)
def test_compile_host_pred_matches_jax(pred):
    cols = _gen(9, 4000)
    masks = {}
    for pkg, parse, Resolver, hpred in (
        ("jax", jax_parse, JaxResolver, jax_hpred),
        ("torch", parse_plan, ExprResolver, compile_host_pred),
    ):
        schema = _PKGS[pkg][0](_FIELDS)
        for name in ("alpha", "beta", "gamma"):
            schema.string_tables["name"].intern(name)
        q = parse(f"from S[{pred}] select small insert into o").queries[0]
        he = hpred(q.input.filters[0],
                   Resolver({"S": ("S", schema)}, default_scope="S"))
        assert he is not None
        masks[pkg] = (np.asarray(he.fn(_host_env(cols))), he.refs)
    (jm, jrefs), (tm, trefs) = masks["jax"], masks["torch"]
    assert trefs == jrefs
    assert tm.dtype == jm.dtype and np.array_equal(tm, jm)
    assert 0 < int(jm.sum()) < 4000


@pytest.mark.parametrize("pred", [
    "math:abs(small) > 3",  # a call stays on the device
    "small + 1",  # not boolean
])
def test_compile_host_pred_refuses_like_jax(pred):
    for pkg, parse, Resolver, hpred in (
        ("jax", jax_parse, JaxResolver, jax_hpred),
        ("torch", parse_plan, ExprResolver, compile_host_pred),
    ):
        schema = _PKGS[pkg][0](_FIELDS)
        q = parse(f"from S[{pred}] select small insert into o").queries[0]
        assert hpred(q.input.filters[0], Resolver(
            {"S": ("S", schema)}, default_scope="S")) is None
