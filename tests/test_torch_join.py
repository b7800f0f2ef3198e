"""Windowed two-stream joins in the torch port, held to the JAX package.

* The cases of ``tests/test_join_e2e.py`` and ``tests/test_join_groupby.py``
  run through the port's API and ``Job`` on the CPU and give the JAX
  package's rows (the same order), and the reference's oracle where the
  reference test uses one.
* ``JoinArtifact.step`` (its pair step ``cuda_ops.join_pairs_plain`` on
  the CPU) equals the reference's step bit for bit, outputs and state, at
  E <= 2,048 over several micro-batches: self-joins, the outer joins,
  ``within``, time windows over unsorted timestamps, an output cut at its
  capacity, string keys, ``/`` and ``%`` in ``on``; the state carried from
  the JAX package into the port mid-stream.
* A step-for-step emulation of K5's walk (``csrc/join_pairs.cu``: the band,
  the binary search over the running maximum of ts, count / scan / write,
  the saturated count) equals
  ``join_pairs_plain`` on random inputs: the kernel's algorithm, checked on
  the CPU before the card holds the kernel to the plain version.
* The wire tape of two streams' batches is bit-equal to the JAX
  package's; a join plan's resident and fused rows equal its streaming
  rows.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_siddhi_tpu import CEPEnvironment as JaxEnv
from flink_siddhi_tpu import SiddhiCEP as JaxCEP
from flink_siddhi_tpu.compiler.config import EngineConfig as JaxConfig
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.sources import BatchSource as JaxSource
from flink_siddhi_tpu.runtime.tape import Tape as JaxTape
from flink_siddhi_tpu.runtime.tape import build_wire_tape as jax_wire
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler import cuda_ops
from flink_siddhi_tpu_torch.compiler.slot_program import eval_program
from flink_siddhi_tpu_torch.query.lexer import SiddhiQLError
from flink_siddhi_tpu_torch.runtime.tape import Tape as TorchTape
from flink_siddhi_tpu_torch.runtime.tape import \
    build_wire_tape as torch_wire

torch.set_num_threads(2)


@dataclasses.dataclass
class Trade:
    sym: int
    price: float
    timestamp: int


@dataclasses.dataclass
class Quote:
    sym: int
    bid: float
    timestamp: int


TF = ["sym", "price", "timestamp"]
QF = ["sym", "bid", "timestamp"]


def join_oracle(trades, quotes, win_t, win_q, on, within=None):
    """The reference test's oracle (tests/test_join_e2e.py): the multiset
    of (trade, quote) pairs a streaming windowed join emits."""
    arrivals = sorted(
        [("t", e) for e in trades] + [("q", e) for e in quotes],
        key=lambda x: x[1].timestamp,
    )
    t_seen, q_seen = [], []
    pairs = []

    def window(seen, win, now_ts):
        kind, n = win
        if kind == "length":
            return seen[-n:]
        return [e for e in seen if e.timestamp > now_ts - n]

    for side, e in arrivals:
        if side == "t":
            for q in window(q_seen, win_q, e.timestamp):
                if on(e, q) and (
                    within is None or abs(e.timestamp - q.timestamp) <= within
                ):
                    pairs.append((e, q))
            t_seen.append(e)
        else:
            for t in window(t_seen, win_t, e.timestamp):
                if on(t, e) and (
                    within is None or abs(t.timestamp - e.timestamp) <= within
                ):
                    pairs.append((t, e))
            q_seen.append(e)
    return pairs


def run_both(trades, quotes, cql, batch_size=4096):
    """The port's rows (CPU) and the JAX package's, through each API."""
    out = []
    for cep, env in ((JaxCEP, JaxEnv(batch_size=batch_size)),
                     (fpt.SiddhiCEP,
                      fpt.CEPEnvironment(batch_size=batch_size,
                                         device="cpu"))):
        out.append(
            cep.define("Trades", trades, TF, env=env)
            .union("Quotes", quotes, QF)
            .cql(cql)
            .returns("out")
        )
    ref, got = out
    assert got == ref
    return got


def mk_trades(n, start=1000, step=1000, syms=3):
    return [Trade(i % syms, 100.0 + i, start + step * i) for i in range(n)]


def mk_quotes(n, start=1500, step=1000, syms=3):
    return [Quote(i % syms, 50.0 + i, start + step * i) for i in range(n)]


# -- tests/test_join_e2e.py ---------------------------------------------------

@pytest.mark.parametrize("batch_size", [4096, 6])
def test_length_window_join(batch_size):
    trades, quotes = mk_trades(12), mk_quotes(10)
    out = run_both(
        trades, quotes,
        "from Trades#window.length(4) as t "
        "join Quotes#window.length(3) as q on t.sym == q.sym "
        "select t.sym, t.price, q.bid insert into out",
        batch_size=batch_size,
    )
    expected = [
        (t.sym, t.price, q.bid)
        for t, q in join_oracle(
            trades, quotes, ("length", 4), ("length", 3),
            lambda t, q: t.sym == q.sym,
        )
    ]
    assert sorted(out) == sorted(expected)


@pytest.mark.parametrize("batch_size", [4096, 5])
def test_time_window_join(batch_size):
    trades, quotes = mk_trades(10), mk_quotes(10)
    out = run_both(
        trades, quotes,
        "from Trades#window.time(3 sec) as t "
        "join Quotes#window.time(2 sec) as q on t.sym == q.sym "
        "select t.price, q.bid insert into out",
        batch_size=batch_size,
    )
    expected = [
        (t.price, q.bid)
        for t, q in join_oracle(
            trades, quotes, ("time", 3000), ("time", 2000),
            lambda t, q: t.sym == q.sym,
        )
    ]
    assert sorted(out) == sorted(expected)


def test_join_compound_on_condition():
    trades, quotes = mk_trades(8), mk_quotes(8)
    out = run_both(
        trades, quotes,
        "from Trades#window.length(5) as t "
        "join Quotes#window.length(5) as q "
        "on t.sym == q.sym and t.price > q.bid + 52.0 "
        "select t.price, q.bid insert into out",
    )
    expected = [
        (t.price, q.bid)
        for t, q in join_oracle(
            trades, quotes, ("length", 5), ("length", 5),
            lambda t, q: t.sym == q.sym and t.price > q.bid + 52.0,
        )
    ]
    assert sorted(out) == sorted(expected)


def test_join_within():
    trades, quotes = mk_trades(8), mk_quotes(8)
    out = run_both(
        trades, quotes,
        "from Trades#window.length(8) as t "
        "join Quotes#window.length(8) as q on t.sym == q.sym "
        "within 1500 select t.price, q.bid insert into out",
    )
    expected = [
        (t.price, q.bid)
        for t, q in join_oracle(
            trades, quotes, ("length", 8), ("length", 8),
            lambda t, q: t.sym == q.sym, within=1500,
        )
    ]
    assert sorted(out) == sorted(expected)


def test_left_outer_join():
    trades = [Trade(0, 100.0, 1000), Trade(7, 101.0, 2000)]
    quotes = [Quote(0, 50.0, 500)]
    out = run_both(
        trades, quotes,
        "from Trades#window.length(4) as t "
        "left outer join Quotes#window.length(4) as q on t.sym == q.sym "
        "select t.sym, q.bid insert into out",
    )
    assert sorted(out, key=str) == [(0, 50.0), (7, None)]


def test_join_select_star():
    trades = [Trade(0, 100.0, 1000)]
    quotes = [Quote(0, 50.0, 1500)]
    out = run_both(
        trades, quotes,
        "from Trades#window.length(4) as t "
        "join Quotes#window.length(4) as q on t.sym == q.sym "
        "insert into out",
    )
    assert out == [(0, 100.0, 1000, 0, 50.0, 1500)]


def test_self_join_on_windowed_stream():
    trades = [Trade(0, 100.0, 1000), Trade(0, 101.0, 2000)]
    out = run_both(
        trades, mk_quotes(1),
        "from Trades#window.length(4) as a "
        "join Trades#window.length(4) as b on a.price < b.price "
        "select a.price as p1, b.price as p2 insert into out",
    )
    assert sorted(out) == [(100.0, 101.0)]


def _job_rows(pkg, cql, schemas, batches, batch_size=8, out="o",
              time_mode="processing"):
    """Rows of ``cql`` over ``batches`` ({stream: [(cols, ts)]}) through
    one package's compile_plan and Job."""
    if pkg == "jax":
        schema_t, batch_t, source_t, compile_, job_t, kw = (
            JaxSchema, JaxBatch, JaxSource, jax_compile, JaxJob, {})
    else:
        schema_t, batch_t, source_t, compile_, job_t, kw = (
            fpt.StreamSchema, fpt.EventBatch, fpt.BatchSource,
            fpt.compile_plan, fpt.Job, {"device": "cpu"})
    sch = {sid: schema_t(fields) for sid, fields in schemas.items()}
    plan = compile_(cql, sch)
    sources = [
        source_t(sid, sch[sid], iter([
            batch_t(sid, sch[sid], cols, ts) for cols, ts in bs
        ]))
        for sid, bs in batches.items()
    ]
    job = job_t([plan], sources, batch_size=batch_size,
                time_mode=time_mode, **kw)
    job.run()
    return job.results(out)


def _both_jobs(cql, schemas, batches, **kw):
    ref = _job_rows("jax", cql, schemas, batches, **kw)
    got = _job_rows("torch", cql, schemas, batches, **kw)
    assert got == ref
    return got


X_FIELDS = [("x", "double"), ("timestamp", "long")]


def test_self_join_with_aliases():
    ts = np.array([1000, 1001, 1002], np.int64)
    rows = _both_jobs(
        "from S as a join S as b on a.x < b.x "
        "select a.x as x1, b.x as x2 insert into o",
        {"S": X_FIELDS},
        {"S": [({"x": np.array([1.0, 3.0, 2.0]), "timestamp": ts}, ts)]},
    )
    assert sorted(rows) == [(1.0, 2.0), (1.0, 3.0), (2.0, 3.0)]


def test_self_join_requires_distinct_aliases():
    S = fpt.StreamSchema(X_FIELDS)
    with pytest.raises(SiddhiQLError, match="distinct aliases"):
        fpt.compile_plan(
            "from S join S on S.x < S.x select S.x as x insert into o",
            {"S": S},
        )


def test_outer_join_missing_side_is_null():
    A = [("id", "int"), ("x", "double"), ("timestamp", "long")]
    B = [("id", "int"), ("y", "double"), ("timestamp", "long")]
    ats = np.array([1000, 1002], np.int64)
    bts = np.array([999], np.int64)
    rows = _both_jobs(
        "from A#window.length(5) left outer join B#window.length(5) "
        "on A.id == B.id select A.id as aid, B.y as by_ insert into o",
        {"A": A, "B": B},
        {"A": [({"id": np.array([1, 7], np.int32),
                 "x": np.array([1.0, 9.0]), "timestamp": ats}, ats)],
         "B": [({"id": np.array([1], np.int32), "y": np.array([10.0]),
                 "timestamp": bts}, bts)]},
    )
    assert sorted(rows, key=str) == [(1, 10.0), (7, None)]


def test_self_join_with_asymmetric_filters():
    trades = [Trade(0, -1.0, 1000), Trade(0, 5.0, 2000)]
    out = run_both(
        trades, mk_quotes(1),
        "from Trades[price > 0.0] as a "
        "join Trades#window.length(4) as b on a.price > b.price "
        "select a.price as p1, b.price as p2 insert into out",
    )
    assert sorted(out) == [(5.0, -1.0)]


def test_self_join_equal_values_no_self_pair():
    trades = [Trade(0, 5.0, 1000), Trade(0, 5.0, 2000)]
    out = run_both(
        trades, mk_quotes(1),
        "from Trades as a join Trades as b on a.price == b.price "
        "select a.timestamp as t1, b.timestamp as t2 insert into out",
    )
    assert sorted(out) == [(1000, 2000), (2000, 1000)]


# -- tests/test_join_groupby.py -----------------------------------------------

GS = [("id", "int"), ("price", "double"), ("timestamp", "long")]
GT = [("id", "int"), ("qty", "int"), ("timestamp", "long")]


def _groupby_data(n=40, seed=13):
    rng = np.random.default_rng(seed)
    ids_s = rng.integers(0, 3, n).astype(np.int32)
    prices = np.round(rng.random(n) * 10, 2)
    ts_s = (1000 + 2 * np.arange(n)).astype(np.int64)
    ids_t = rng.integers(0, 3, n).astype(np.int32)
    qty = rng.integers(1, 5, n).astype(np.int32)
    ts_t = (1001 + 2 * np.arange(n)).astype(np.int64)
    return ids_s, prices, ts_s, ids_t, qty, ts_t


def _groupby_rows(cql, n=40, batch=24):
    ids_s, prices, ts_s, ids_t, qty, ts_t = data = _groupby_data(n)

    def split(cols, ts):
        return [({k: v[i:i + batch] for k, v in cols.items()},
                 ts[i:i + batch]) for i in range(0, n, batch)]

    rows = _both_jobs(cql, {"S": GS, "T": GT}, {
        "S": split({"id": ids_s, "price": prices, "timestamp": ts_s}, ts_s),
        "T": split({"id": ids_t, "qty": qty, "timestamp": ts_t}, ts_t),
    }, batch_size=batch)
    return rows, data


def _join_rows(data, win=4):
    ids_s, prices, ts_s, ids_t, qty, ts_t = data
    events = sorted(
        [(int(t), "S", int(i), float(p))
         for t, i, p in zip(ts_s, ids_s, prices)]
        + [(int(t), "T", int(i), int(k))
           for t, i, k in zip(ts_t, ids_t, qty)]
    )
    ring = {"S": [], "T": []}
    rows = []
    for t, side, k, v in events:
        other = "T" if side == "S" else "S"
        for (ot, ok, ov) in ring[other][-win:]:
            if ok == k:
                rows.append((t, k, v, ov) if side == "S" else (t, k, ov, v))
        ring[side].append((t, k, v))
    return rows


def test_join_direct_groupby_sum():
    rows, data = _groupby_rows(
        "from S#window.length(4) join T#window.length(4) on S.id == T.id "
        "select S.id as k, sum(T.qty) as total "
        "group by S.id insert into o"
    )
    sums, exp = {}, []
    for _, k, _p, q_ in _join_rows(data):
        sums[k] = sums.get(k, 0) + q_
        exp.append((k, sums[k]))
    assert rows == exp and len(rows) > 0


def test_join_direct_having():
    rows, data = _groupby_rows(
        "from S#window.length(4) join T#window.length(4) on S.id == T.id "
        "select S.id as k, count() as c group by S.id "
        "having c > 5 insert into o"
    )
    cnt, exp = {}, []
    for _, k, _p, _q in _join_rows(data):
        cnt[k] = cnt.get(k, 0) + 1
        if cnt[k] > 5:
            exp.append((k, cnt[k]))
    assert rows == exp and len(rows) > 0


def test_join_direct_groupby_string_key():
    syms = ["aaa", "bbb", "ccc"]
    n, batch = 40, 24
    rng = np.random.default_rng(13)
    cs = rng.integers(0, 3, n)
    prices = np.round(rng.random(n) * 10, 2)
    ts_s = (1000 + 2 * np.arange(n)).astype(np.int64)
    ct = rng.integers(0, 3, n)
    qty = rng.integers(1, 5, n).astype(np.int32)
    ts_t = (1001 + 2 * np.arange(n)).astype(np.int64)
    cql = (
        "from S#window.length(4) join T#window.length(4) "
        "on S.sym == T.sym "
        "select S.sym as k, sum(T.qty) as total "
        "group by S.sym insert into o"
    )
    out = []
    for schema_t, batch_t, source_t, compile_, job_t, kw in (
        (JaxSchema, JaxBatch, JaxSource, jax_compile, JaxJob, {}),
        (fpt.StreamSchema, fpt.EventBatch, fpt.BatchSource,
         fpt.compile_plan, fpt.Job, {"device": "cpu"}),
    ):
        S2 = schema_t([("sym", "string"), ("price", "double"),
                       ("timestamp", "long")])
        shared = S2.string_tables["sym"]
        T2 = schema_t([("sym", "string"), ("qty", "int"),
                       ("timestamp", "long")], shared_strings=shared)
        codes_s = np.asarray([shared.intern(syms[c]) for c in cs], np.int32)
        codes_t = np.asarray([shared.intern(syms[c]) for c in ct], np.int32)
        plan = compile_(cql, {"S": S2, "T": T2})

        def src(sid, sch, cols, ts):
            return source_t(sid, sch, iter([
                batch_t(sid, sch, {k: v[i:i + batch] for k, v in
                                   cols.items()}, ts[i:i + batch])
                for i in range(0, n, batch)
            ]))

        job = job_t([plan], [
            src("S", S2, {"sym": codes_s, "price": prices,
                          "timestamp": ts_s}, ts_s),
            src("T", T2, {"sym": codes_t, "qty": qty,
                          "timestamp": ts_t}, ts_t),
        ], batch_size=batch, time_mode="processing", **kw)
        job.run()
        out.append(job.results("o"))
    ref, rows = out
    assert rows == ref
    sums, exp = {}, []
    for _, k, _p, q_ in _join_rows((cs, prices, ts_s, ct, qty, ts_t)):
        sums[k] = sums.get(k, 0) + q_
        exp.append((syms[k], sums[k]))
    assert rows == exp and len(rows) > 0


# -- the step against the reference's -----------------------------------------

STEP_FIELDS = [("id", "int"), ("name", "string"), ("price", "double"),
               ("vol", "int"), ("timestamp", "long")]

STEP_CASES = {
    "length_time": (
        "from A#window.length(16) as a join B#window.time(40) as b "
        "on a.id == b.id select a.price as p, b.vol as v, b.timestamp as t "
        "insert into o", {}),
    "self_join": (
        "from A#window.length(24) as a join A#window.length(24) as b "
        "on a.id == b.id and a.price < b.price "
        "select a.price as p1, b.price as p2 insert into o", {}),
    "left_outer": (
        "from A[price > 30.0]#window.length(8) as a left outer join "
        "B#window.length(8) as b on a.id == b.id "
        "select a.id as i, b.price as p insert into o", {}),
    "right_outer": (
        "from A#window.time(30) as a right outer join B#window.length(8) "
        "as b on a.id == b.id and a.vol > b.vol "
        "select a.vol as v, b.id as i insert into o", {}),
    "full_outer_within": (
        "from A#window.length(32) as a full outer join "
        "B#window.time(50) as b on a.id == b.id within 12 "
        "select a.timestamp as ta, b.timestamp as tb insert into o", {}),
    "unbounded_side": (
        "from A as a join B#window.time(20) as b on a.vol + 200 < b.vol "
        "select a.vol as v1, b.vol as v2 insert into o", {}),
    "past_cap": (
        "from A#window.length(64) as a join B#window.length(64) as b "
        "on a.id == b.id select a.price as p, b.price as q insert into o",
        {"join_out_factor": 1}),
    "string_keys": (
        "from A#window.length(16) as a join B#window.time(30) as b "
        "on a.name == b.name and a.id == b.id "
        "select a.name as n, b.id as i insert into o", {}),
    "div_mod": (
        "from A#window.length(16) as a join B#window.length(16) as b "
        "on a.vol / (b.id + 1) > 10 and a.vol % 7 == b.id % 7 "
        "and a.price / b.price > 1.0 and b.price % 3.5 < a.price % 2.5 "
        "select a.vol as v, b.id as i insert into o", {}),
}


def _step_tapes(n_batches, E, seed, unsorted=False, n_ids=6):
    """Raw tapes (numpy) of two streams A (code 0) and B (code 1)."""
    rng = np.random.default_rng(seed)
    tapes = []
    t0 = 0
    for _ in range(n_batches):
        m = E - int(rng.integers(0, E // 8 + 1))
        ts = np.zeros(E, np.int32)
        ts[:m] = np.sort(t0 + rng.integers(0, m, m)).astype(np.int32)
        if unsorted:
            # a few events out of order (a time window's ts not monotone)
            k = rng.choice(m, m // 16, replace=False)
            ts[k] -= rng.integers(0, 60, len(k)).astype(np.int32)
        ts[m:] = ts[m - 1] if m else 0
        t0 += m
        stream = np.full(E, -1, np.int32)
        stream[:m] = rng.integers(0, 2, m)
        valid = np.zeros(E, bool)
        valid[:m] = True
        cols = {}
        for sid in ("A", "B"):
            cols[f"{sid}.id"] = rng.integers(0, n_ids, E).astype(np.int32)
            cols[f"{sid}.name"] = rng.integers(0, 3, E).astype(np.int32)
            cols[f"{sid}.price"] = (rng.random(E) * 100).astype(np.float32)
            cols[f"{sid}.vol"] = rng.integers(-50, 200, E).astype(np.int32)
            cols[f"{sid}.timestamp"] = ts + 1000
        tapes.append((ts, stream, valid, cols))
    return tapes


def _assert_tree_equal(ref, got, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _assert_tree_equal(ref[k], got[k], f"{path}.{k}")
        return
    r, g = np.asarray(ref), got.numpy()
    assert r.dtype == g.dtype and r.shape == g.shape, path
    if r.dtype == np.float32:
        r, g = r.view(np.int32), g.view(np.int32)
    assert np.array_equal(r, g), path


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("E", [256, 2048])
def test_join_step_matches_the_reference(case, E):
    cql, cfg = STEP_CASES[case]
    schemas_j = {s: JaxSchema(STEP_FIELDS) for s in ("A", "B")}
    shared = schemas_j["A"].string_tables["name"]
    schemas_j["B"] = JaxSchema(STEP_FIELDS, shared_strings=shared)
    schemas_t = {s: fpt.StreamSchema(STEP_FIELDS) for s in ("A", "B")}
    schemas_t["B"] = fpt.StreamSchema(
        STEP_FIELDS, shared_strings=schemas_t["A"].string_tables["name"])
    for sch in (schemas_j, schemas_t):
        tab = sch["A"].string_tables["name"]
        for w in ("x", "y", "z"):
            tab.intern(w)
    jplan = jax_compile(cql, schemas_j, config=JaxConfig(**cfg))
    tplan = fpt.compile_plan(cql, schemas_t, config=fpt.EngineConfig(**cfg))
    jart, tart = jplan.artifacts[0], tplan.artifacts[0]
    assert type(tart).__name__ == "JoinArtifact"
    jst = jart.init_state()
    tst = None
    overflow_seen = 0
    tapes = _step_tapes(4, E, seed=E + len(case),
                        unsorted=case == "length_time")
    for k, (ts, stream, valid, cols) in enumerate(tapes):
        jt = JaxTape(jnp.asarray(ts), jnp.asarray(stream),
                     jnp.asarray(valid),
                     {c: jnp.asarray(v) for c, v in cols.items()})
        tt = TorchTape(torch.from_numpy(ts), torch.from_numpy(stream),
                       torch.from_numpy(valid),
                       {c: torch.from_numpy(v) for c, v in cols.items()})
        if k == 2:
            # the reference's state, carried into the port mid-stream
            np_state = {jart.name: {kk: np.asarray(v)
                                    for kk, v in jst.items()}}
            tst = fpt.state_from_numpy(tplan, np_state, "cpu")[tart.name]
        elif tst is None:
            tst = tart.init_state("cpu")
        jst, (jn, jts, jcols) = jart.step(jst, jt)
        tst, (tn, tts, tcols) = tart.step(tst, tt)
        n = int(jn)
        assert int(tn) == n
        assert np.array_equal(np.asarray(jts)[:n], tts.numpy()[:n])
        assert len(jcols) == len(tcols)
        for jc, tc in zip(jcols, tcols):
            jc = np.asarray(jc)[:n]
            tc = tc.numpy()[:n]
            if jc.dtype == np.float32:
                jc, tc = jc.view(np.int32), tc.view(np.int32)
            assert np.array_equal(jc, tc.astype(jc.dtype))
        _assert_tree_equal(jst, tst)
        overflow_seen = int(tst["overflow"])
    if case == "past_cap":
        assert overflow_seen > 0
    else:
        assert overflow_seen == 0


def test_join_on_call_over_one_side_is_a_derived_column():
    cql = ("from A#window.length(8) as a join B#window.length(8) as b "
           "on math:abs(a.vol) > b.vol + 3 and b.id == a.id "
           "select a.vol as v, b.vol as w insert into o")
    schemas = {s: fpt.StreamSchema(STEP_FIELDS) for s in ("A", "B")}
    plan = fpt.compile_plan(cql, schemas)
    art = plan.artifacts[0]
    assert len(art.derived) == 1
    jplan = jax_compile(cql, {s: JaxSchema(STEP_FIELDS) for s in "AB"})
    jst, tst = jplan.artifacts[0].init_state(), art.init_state("cpu")
    for ts, stream, valid, cols in _step_tapes(3, 256, seed=4):
        jt = JaxTape(jnp.asarray(ts), jnp.asarray(stream),
                     jnp.asarray(valid),
                     {c: jnp.asarray(v) for c, v in cols.items()})
        tt = TorchTape(torch.from_numpy(ts), torch.from_numpy(stream),
                       torch.from_numpy(valid),
                       {c: torch.from_numpy(v) for c, v in cols.items()})
        jst, (jn, _, jc) = jplan.artifacts[0].step(jst, jt)
        tst, (tn, _, tc) = art.step(tst, tt)
        n = int(jn)
        assert int(tn) == n and n > 0
        for a, b in zip(jc, tc):
            assert np.array_equal(np.asarray(a)[:n], b.numpy()[:n])


def test_join_on_call_over_both_sides_names_its_item():
    schemas = {s: fpt.StreamSchema(STEP_FIELDS) for s in ("A", "B")}
    with pytest.raises(SiddhiQLError, match="item 8") as exc:
        fpt.compile_plan(
            "from A#window.length(8) as a join B#window.length(8) as b "
            "on math:abs(a.vol - b.vol) < 3 "
            "select a.vol as v insert into o", schemas)
    assert "both sides" in str(exc.value)


# -- K5's algorithm, emulated ------------------------------------------------

def _emulate_k5(dirs, ts, cap, self_join, within):
    """csrc/join_pairs.cu step by step in Python: per (direction, i) the
    band (a length window's ordinals; a time window's binary search over
    the running maximum of valid ts), the walk's checks, the counts, the
    scan over the four segments, the writes below cap and the count
    saturated at ``N_MAX``."""
    E = int(ts.shape[0])
    ts = ts.tolist()

    def wrap(x):
        return (x + 2 ** 31) % 2 ** 32 - 2 ** 31

    def walk(d, i):
        base = int(d.b_seen[0]) - d.C
        cum = int(d.b_cum[i])
        hi = min(cum - base, int(d.b_ts.shape[0]))
        lo = 0
        tlo = wrap(ts[i] - d.span)
        b_ts = d.b_ts.tolist()
        # the kernel's running max of the valid ts
        tsmax = np.maximum.accumulate(np.where(
            d.b_valid.numpy(), d.b_ts.numpy(),
            np.iinfo(np.int32).min)).tolist()
        if not d.mode_time:
            lo = max(cum - d.n - base, 0)
        else:
            a, b = 0, max(hi, 0)
            while a < b:
                m = (a + b) >> 1
                if tsmax[m] > tlo:
                    b = m
                else:
                    a = m + 1
            lo = a
        out = []
        for j in range(lo, hi):
            if not bool(d.b_valid[j]):
                continue
            if self_join and int(d.b_posid[j]) == i:
                continue
            if d.mode_time and not b_ts[j] > tlo:
                continue
            if within is not None:
                dd = wrap(ts[i] - b_ts[j])
                if abs(dd) > within and dd != -2 ** 31:
                    continue
            if d.prog:
                ok = eval_program(d.prog, lambda c: d.a_cols[c][i],
                                  lambda c: d.b_cols[c][j])
                if int(ok) == 0:
                    continue
            out.append(j)
        return out

    cnt = np.zeros(4 * E, np.int64)
    walks = {}
    for di, d in enumerate(dirs):
        for i in range(E):
            if bool(d.a_mask[i]):
                walks[(di, i)] = w = walk(d, i)
                cnt[2 * di * E + i] = len(w)
                cnt[(2 * di + 1) * E + i] = int(d.outer and not w)
    off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    n = min(int(cnt.sum()), cuda_ops.N_MAX)
    oi, oj, og = (np.zeros(cap, np.int32) for _ in range(3))
    for di in range(2):
        for i in range(E):
            o = off[2 * di * E + i]
            for k, j in enumerate(walks.get((di, i), ())):
                if o + k < cap:
                    oi[o + k], oj[o + k], og[o + k] = i, j, 2 * di
            if cnt[(2 * di + 1) * E + i] and off[(2 * di + 1) * E + i] < cap:
                r = off[(2 * di + 1) * E + i]
                oi[r], oj[r], og[r] = i, 0, 2 * di + 1
    return oi, oj, og, n


def _random_dirs(rng, E, C, mode_time, sorted_ts, outer, prog):
    dirs = []
    ts = np.sort(rng.integers(0, 4 * E, E)).astype(np.int32)
    for di in range(2):
        Nb = C + E
        mask = rng.random(E) < 0.5
        M = int(mask.sum())
        seen = int(rng.integers(0, 3 * C))
        b_ts = np.concatenate([np.sort(rng.integers(-50, 20, C)),
                               np.sort(rng.integers(0, 4 * E, E))])
        if not sorted_ts:
            b_ts = rng.permutation(b_ts)
        b_ts = b_ts.astype(np.int32)
        ring_valid = np.arange(C) >= C - min(seen, C)
        b_valid = np.concatenate([ring_valid, np.arange(E) < M])
        b_posid = np.concatenate([np.full(C, -1),
                                  rng.permutation(E)]).astype(np.int32)
        b_cum = (seen + np.cumsum(rng.random(E) < 0.5)).astype(np.int32)
        b_cum = np.minimum(b_cum, seen + M).astype(np.int32)
        dirs.append(cuda_ops.JoinDir(
            a_mask=torch.from_numpy(mask),
            a_cols=torch.from_numpy(
                rng.integers(0, 4, (1, E)).astype(np.int32)),
            b_ts=torch.from_numpy(b_ts), b_valid=torch.from_numpy(b_valid),
            b_posid=torch.from_numpy(b_posid),
            b_cum=torch.from_numpy(b_cum),
            b_seen=torch.tensor([seen], dtype=torch.int32),
            b_cols=torch.from_numpy(
                rng.integers(0, 4, (1, Nb)).astype(np.int32)),
            prog=prog, depth=2, mode_time=mode_time,
            n=min(C, 7) if not mode_time else C, span=int(E // 2),
            C=C, outer=outer and di == 0,
        ))
    return dirs, torch.from_numpy(ts)


@pytest.mark.parametrize("mode_time,sorted_ts", [(False, True),
                                                 (True, True),
                                                 (True, False)])
@pytest.mark.parametrize("cap_div", [1, 8])
def test_k5_walk_emulation_equals_the_plain_version(mode_time, sorted_ts,
                                                    cap_div):
    from flink_siddhi_tpu_torch.compiler import slot_program as sp

    rng = np.random.default_rng(int(mode_time) * 10 + int(sorted_ts))
    E, C = 96, 16
    prog = (sp.OP_EVT, sp.OP_CAP, sp.OP_EQ_I)
    for self_join, within, outer in ((False, None, True), (True, 40, False),
                                     (False, 25, True)):
        dirs, ts = _random_dirs(rng, E, C, mode_time, sorted_ts, outer,
                                prog)
        cap = 4 * E
        if cap_div > 1:  # cut inside the output
            full = cuda_ops.join_pairs_plain(dirs, ts, cap, self_join,
                                             within)[3]
            cap = max(1, int(full[0]) // cap_div)
        pi, pj, pg, n = cuda_ops.join_pairs_plain(dirs, ts, cap, self_join,
                                                  within)
        ei, ej, eg, en = _emulate_k5(dirs, ts, cap, self_join, within)
        assert int(n[0]) == en and en > 0
        assert np.array_equal(pi.numpy(), ei)
        assert np.array_equal(pj.numpy(), ej)
        assert np.array_equal(pg.numpy(), eg)
        if cap_div > 1:
            assert en > cap  # the cut is exercised


@pytest.mark.parametrize("mode_time", [False, True])
def test_join_pair_count_saturates(mode_time, monkeypatch):
    """A batch's pair count past ``N_MAX`` (2^31 - 1 on the card, where
    K5 scans in 64 bits) reads ``N_MAX``; the ranks below cap are those of
    the unsaturated count. Checked with the limit lowered below the count,
    in the plain version and in the emulation of K5."""
    from flink_siddhi_tpu_torch.compiler import slot_program as sp

    rng = np.random.default_rng(7 + int(mode_time))
    dirs, ts = _random_dirs(rng, 96, 16, mode_time, True, True,
                            (sp.OP_EVT, sp.OP_CAP, sp.OP_EQ_I))
    cap = 64
    full = cuda_ops.join_pairs_plain(dirs, ts, cap, False, None)
    n = int(full[3][0])
    assert n > cap
    monkeypatch.setattr(cuda_ops, "N_MAX", n // 2)
    got = cuda_ops.join_pairs_plain(dirs, ts, cap, False, None)
    emu = _emulate_k5(dirs, ts, cap, False, None)
    assert int(got[3][0]) == emu[3] == n // 2
    for a, b, e in zip(full[:3], got[:3], emu[:3]):
        assert torch.equal(a, b)
        assert np.array_equal(b.numpy(), e)


# -- the runtime with two streams --------------------------------------------

def _two_stream_batches(n, seed, lo=0, gap=3):
    rng = np.random.default_rng(seed)
    out = {}
    for k, sid in enumerate(("A", "B")):
        ts = (1000 + np.sort(rng.integers(0, n * gap, n)) + k).astype(
            np.int64)
        out[sid] = {"id": rng.integers(0, 5, n).astype(np.int32),
                    "name": rng.integers(0, 3, n),
                    "price": rng.random(n) * 100,
                    "vol": rng.integers(lo, 900, n).astype(np.int32),
                    "timestamp": ts, "ts": ts}
    return out


def test_two_stream_wire_tape_is_bit_equal_to_the_reference():
    data = _two_stream_batches(300, seed=3)
    cql = ("from A#window.length(8) as a join B#window.time(20) as b "
           "on a.id == b.id select a.price as p, b.vol as v insert into o")
    tapes = []
    for schema_t, batch_t, compile_, wire in (
        (JaxSchema, JaxBatch, jax_compile, jax_wire),
        (fpt.StreamSchema, fpt.EventBatch, fpt.compile_plan, torch_wire),
    ):
        sch = {s: schema_t(STEP_FIELDS) for s in ("A", "B")}
        plan = compile_(cql, sch)
        sticky = {}
        out = []
        for lo in range(0, 300, 100):
            batches = []
            for sid in ("A", "B"):
                d = data[sid]
                names = np.asarray(["x", "y", "z"])[d["name"][lo:lo + 100]]
                cols = {k: d[k][lo:lo + 100] for k in
                        ("id", "price", "vol", "timestamp")}
                cols["name"] = np.asarray(
                    [sch[sid].string_tables["name"].intern(v)
                     for v in names], np.int32)
                batches.append(batch_t(sid, sch[sid], cols,
                                       d["ts"][lo:lo + 100]))
            w, _ = wire(plan.spec, batches, 1000, sticky, capacity=256)
            out.append(w)
        tapes.append(out)
    for jw, tw in zip(*tapes):
        assert jw.kinds == tw.kinds and jw.ts_kind == tw.ts_kind
        assert np.array_equal(np.asarray(jw.ts), np.asarray(tw.ts))
        assert np.array_equal(np.asarray(jw.stream), np.asarray(tw.stream))
        assert set(jw.cols) == set(tw.cols)
        for k in jw.cols:
            assert np.array_equal(np.asarray(jw.cols[k]),
                                  np.asarray(tw.cols[k])), k
        assert int(np.asarray(jw.n_valid)[0]) == int(
            np.asarray(tw.n_valid)[0])


def _join_job(cql, data, batch, device="cpu", **job_kw):
    sch = {s: fpt.StreamSchema(STEP_FIELDS) for s in ("A", "B")}
    plan = fpt.compile_plan(cql, sch, config=fpt.EngineConfig(
        lazy_projection=True, pred_pushdown=True))
    sources = []
    for sid in ("A", "B"):
        d = data[sid]
        n = len(d["ts"])
        cols = {k: d[k] for k in ("id", "price", "vol", "timestamp")}
        cols["name"] = d["name"].astype(np.int32)
        sources.append(fpt.BatchSource(sid, sch[sid], iter([
            fpt.EventBatch(sid, sch[sid],
                           {k: v[i:i + batch] for k, v in cols.items()},
                           d["ts"][i:i + batch])
            for i in range(0, n, batch)
        ])))
    return fpt.Job([plan], sources, batch_size=batch, device=device,
                   **job_kw)


def test_join_resident_and_fused_rows_equal_the_streaming_rows():
    data = _two_stream_batches(1200, seed=9)
    cql = ("from A#window.length(16) as a join B#window.time(30) as b "
           "on a.id == b.id select a.price as p, b.vol as v, "
           "b.timestamp as t insert into o")
    job = _join_job(cql, data, 128)
    job.run()
    job.flush()
    rows = job.results("o")
    assert len(rows) > 100
    fused = _join_job(cql, data, 128)
    fused.fused_segment_len = 4
    fused.run()
    fused.flush()
    assert fused.results("o") == rows
    assert fused.eager_segments == 0
    rjob = _join_job(cql, data, 128)
    rep = fpt.ResidentReplay(rjob)
    rep.stage()
    rep.run()
    rjob.flush()
    assert rjob.results("o") == rows
    assert rjob.eager_segments == 0
    ref = _job_rows("jax", cql, {s: STEP_FIELDS for s in "AB"}, {
        sid: [({k: data[sid][k][i:i + 128] for k in
                ("id", "price", "vol", "timestamp")}
               | {"name": data[sid]["name"][i:i + 128].astype(np.int32)},
               data[sid]["ts"][i:i + 128]) for i in range(0, 1200, 128)]
        for sid in "AB"}, batch_size=128, time_mode="event")
    assert rows == ref


@pytest.mark.parametrize("outer", [False, True])
def test_join_columnar_sink_gets_the_rows(outer):
    data = _two_stream_batches(600, seed=5)
    cql = ("from A#window.length(8) as a "
           + ("left outer join" if outer else "join")
           + " B#window.time(20) as b on a.id == b.id "
           "select a.id as i, b.price as p insert into o")
    job = _join_job(cql, data, 128)
    job.run()
    job.flush()
    rows = job.results_with_ts("o")
    cjob = _join_job(cql, data, 128, retain_results=False)

    class Cols:
        parts = []

        def accept_columns(self, ts, cols):
            self.parts.append((np.asarray(ts), cols))

    sink = Cols()
    cjob.add_sink("o", sink)
    cjob.run()
    cjob.flush()
    got = [(int(t), tuple(None if v is None else v for v in vals))
           for ts, cols in sink.parts
           for t, *vals in zip(ts, cols["i"], cols["p"])]
    assert got == rows and len(rows) > 50
    assert any(r[1][1] is None for r in rows) == outer


@pytest.mark.parametrize("cql", [
    "from A#window.length(16) as a join B#window.time(30) as b "
    "on a.id == b.id and a.price > b.price / 2.0 "
    "select a.price as p, b.vol as v insert into o",
    "from A#window.length(16) as a full outer join B#window.time(30) as b "
    "on a.id == b.id within 10 select a.id as i, b.id as j insert into o",
    "from A#window.length(8) as a join B#window.length(8) as b "
    "on a.id == b.id select a.id as id, sum(b.price) as s "
    "group by a.id insert into o",
], ids=["join", "outer", "aggregated"])
def test_join_segment_body_makes_no_host_read(cql, monkeypatch):
    """The join step (and the chained aggregation after it) reads nothing
    on the host, what a CUDA graph could not capture: the segment body
    under the host-read guard of tests/test_torch_segments.py, with the
    pair step itself (on the card one K5 call, three launches that leave n
    on the device; here its plain version, which reads on the host) run
    with the guard paused and its outputs marked derived."""
    from test_torch_segments import HostReadGuard

    from flink_siddhi_tpu_torch.runtime.graphs import step_segment

    job = _join_job(cql, _two_stream_batches(400, seed=7), 128,
                    retain_results=False)
    rep = fpt.ResidentReplay(job)
    rep.stage()
    (rt,) = job._plans.values()
    (seg, *_), = rep.segments.values()
    tapes = seg.tapes()

    class Guard(HostReadGuard):
        paused = False

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if self.paused:
                return func(*args, **(kwargs or {}))
            return super().__torch_function__(func, types, args, kwargs)

    guard = Guard([[t.arrays() for t in tapes], rt.states, rt.acc])
    calls = []
    real = cuda_ops.join_pairs

    def pairs(*args):
        calls.append(args)
        guard.paused = True
        try:
            out = real(*args)
        finally:
            guard.paused = False
        for t in out:
            guard._mark(t)
        return out

    monkeypatch.setattr(cuda_ops, "join_pairs", pairs)
    with guard:
        _, acc = step_segment(rt.plan, rt.states, rt.acc, tapes)
    assert len(calls) == len(tapes)
    assert int(acc["meta"][0].sum()) > 0
