"""Query chaining and the plan rewrites in the torch port, held to the JAX
package.

* The cases of ``tests/test_query_chaining.py`` (an aggregate over a
  windowed join, a filter pipe, a pattern into a windowed aggregate, the
  chained refusals) run through the port's API on the CPU and give the
  JAX package's rows and the reference test's oracle.
* ``insert all events`` (``tests/test_expired_events.py``): the
  current-events and expired-events halves of the reference's rewrite.
* The three ``PLAN_ZOO`` plans this slice adds (``window_join``,
  ``join_groupby_rewrite``, ``chained_composition``) give the JAX package's
  rows at dryrun size, streaming, fused and resident.
* The chained refusals keep the reference's messages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flink_siddhi_tpu import CEPEnvironment as JaxEnv
from flink_siddhi_tpu import SiddhiCEP as JaxCEP
from flink_siddhi_tpu.analysis.zoo import PLAN_ZOO
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.query.lexer import SiddhiQLError as JaxQLError
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.sources import BatchSource as JaxSource
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.query.lexer import SiddhiQLError

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


def mk_trades(n, start=1000, step=1000, syms=3):
    return [Trade(i % syms, 100.0 + i, start + step * i) for i in range(n)]


def mk_quotes(n, start=1500, step=1000, syms=3):
    return [Quote(i % syms, 50.0 + i, start + step * i) for i in range(n)]


def join_pairs(trades, quotes, nt, nq):
    """The reference test's oracle: equi-join pairs of a streaming
    length-window join."""
    arrivals = sorted(
        [("t", e) for e in trades] + [("q", e) for e in quotes],
        key=lambda x: x[1].timestamp,
    )
    t_seen, q_seen, pairs = [], [], []
    for side, e in arrivals:
        if side == "t":
            pairs += [(e, q) for q in q_seen[-nq:] if q.sym == e.sym]
            t_seen.append(e)
        else:
            pairs += [(t, e) for t in t_seen[-nt:] if t.sym == e.sym]
            q_seen.append(e)
    return pairs


def both(build, out, how="returns"):
    """``build(cep, env)`` -> a stream with ``.cql`` applied, through each
    package's API (the port on the CPU); the port's output, after
    checking it equals the reference's."""
    res = []
    for cep, env in ((JaxCEP, lambda **kw: JaxEnv(**kw)),
                     (fpt.SiddhiCEP,
                      lambda **kw: fpt.CEPEnvironment(device="cpu", **kw))):
        res.append(getattr(build(cep, env), how)(out))
    ref, got = res
    assert got == ref
    return got


@pytest.mark.parametrize("batch_size", [4096, 7])
def test_aggregate_over_windowed_join(batch_size):
    trades, quotes = mk_trades(12), mk_quotes(10)
    out = both(
        lambda cep, env: cep.define(
            "Trades", trades, TF, env=env(batch_size=batch_size))
        .union("Quotes", quotes, QF)
        .cql(
            "from Trades#window.length(4) as t "
            "join Quotes#window.length(3) as q on t.sym == q.sym "
            "select t.sym as sym, t.price + q.bid as v insert into mid; "
            "from mid select sum(v) as total, count() as cnt "
            "insert into out"
        ), "out", "return_as_map",
    )
    pairs = join_pairs(trades, quotes, 4, 3)
    assert out, "no aggregate rows emitted"
    final = max(out, key=lambda m: m["cnt"])
    assert final["cnt"] == len(pairs)
    assert abs(
        final["total"] - sum(t.price + q.bid for t, q in pairs)
    ) < 1e-6


def test_filter_chain_pipe():
    evs = [Trade(i % 5, float(i), 1000 + i) for i in range(50)]
    out = both(
        lambda cep, env: cep.define("S", evs, TF, env=env()).cql(
            "from S[sym == 2] select sym, price insert into mid; "
            "from mid[price > 20.0] select price insert into out"
        ), "out",
    )
    assert out == [(e.price,) for e in evs if e.sym == 2 and e.price > 20.0]


def test_pattern_into_windowed_aggregate():
    evs = [Trade(i % 4, float(i), 1000 + 1000 * i) for i in range(40)]
    out = both(
        lambda cep, env: cep.define("S", evs, TF, env=env()).cql(
            "from every s1 = S[sym == 1] -> s2 = S[sym == 2] "
            "select s2.price as p insert into mid; "
            "from mid#window.lengthBatch(4) select sum(p) as total "
            "insert into out"
        ), "out", "return_as_map",
    )
    ps = []
    pending = 0
    for e in evs:
        if e.sym == 1:
            pending += 1
        elif e.sym == 2 and pending:
            ps += [e.price] * pending
            pending = 0
    batches = [ps[i:i + 4] for i in range(0, len(ps) - len(ps) % 4, 4)]
    assert [m["total"] for m in out] == [sum(b) for b in batches]


def test_chained_errors():
    evs = [Trade(0, 1.0, 1000)]
    base = fpt.SiddhiCEP.define("S", evs, TF, device="cpu")
    with pytest.raises(SiddhiQLError):
        base.cql(
            "from mid select price insert into out; "
            "from S select sym, price insert into mid"
        ).returns("out")
    with pytest.raises(SiddhiQLError):
        base.cql(
            "from S select sym, price, timestamp insert into mid; "
            "from every a = mid[sym == 1] -> b = mid[sym == 2] "
            "select a.price as p insert into out"
        ).returns("out")


def test_chained_group_by_clear_error():
    evs = [Trade(0, 1.0, 1000)]
    with pytest.raises(SiddhiQLError, match="chained stream"):
        fpt.SiddhiCEP.define("S", evs, TF, device="cpu").cql(
            "from S select sym, price insert into mid; "
            "from mid select sym, sum(price) as t group by sym "
            "insert into out"
        ).returns("out")


ID_FIELDS = [("id", "int"), ("price", "double"), ("timestamp", "long")]


def _rows(pkg, cql, cols_by_stream, fields_by_stream, batch, out,
          with_ts=False, resident=False, **job_kw):
    if pkg == "jax":
        schema_t, batch_t, source_t, compile_, job_t, kw = (
            JaxSchema, JaxBatch, JaxSource, jax_compile, JaxJob, {})
    else:
        schema_t, batch_t, source_t, compile_, job_t, kw = (
            fpt.StreamSchema, fpt.EventBatch, fpt.BatchSource,
            fpt.compile_plan, fpt.Job, {"device": "cpu"})
    first = None
    sch = {}
    for sid, fields in fields_by_stream.items():
        sch[sid] = schema_t(fields, shared_strings=first)
        if first is None and sch[sid].string_tables:
            first = next(iter(sch[sid].string_tables.values()))
    plan = compile_(cql, sch)
    sources = []
    for sid, cols in cols_by_stream.items():
        cols = dict(cols)
        for name, table in sch[sid].string_tables.items():
            if cols[name].dtype.kind in "US":
                cols[name] = np.asarray(
                    [table.intern(str(v)) for v in cols[name]], np.int32)
        ts = cols["timestamp"]
        n = len(ts)
        sources.append(source_t(sid, sch[sid], iter([
            batch_t(sid, sch[sid], {k: v[i:i + batch] for k, v in
                                    cols.items()}, ts[i:i + batch])
            for i in range(0, n, batch)
        ])))
    job = job_t([plan], sources, batch_size=batch, time_mode="processing",
                **kw)
    for k, v in job_kw.items():
        setattr(job, k, v)
    if resident:
        rep = fpt.ResidentReplay(job)
        rep.stage()
        rep.run()
    else:
        job.run()
    job.flush()
    return job.results_with_ts(out) if with_ts else job.results(out)


def test_all_events_emits_current_and_expired():
    ids = list(range(6))
    cols = {"S": {"id": np.asarray(ids, np.int32),
                  "price": np.asarray(ids, np.float64),
                  "timestamp": np.asarray([1000 + i for i in ids],
                                          np.int64)}}
    cql = ("from S#window.length(2) select id, price "
           "insert all events into o")
    rows = _rows("torch", cql, cols, {"S": ID_FIELDS}, 4, "o", True)
    assert rows == _rows("jax", cql, cols, {"S": ID_FIELDS}, 4, "o", True)
    expect = sorted(
        [(1000 + i, (i, float(i))) for i in range(6)]
        + [(1002 + i, (i, float(i))) for i in range(4)]
    )
    assert sorted(rows) == expect


def test_all_events_with_output_rate_keeps_the_reference_message():
    cql = ("from S#window.length(2) select id "
           "output last every 2 events insert all events into o")
    with pytest.raises(JaxQLError) as ref:
        jax_compile(cql, {"S": JaxSchema(ID_FIELDS)})
    with pytest.raises(SiddhiQLError) as got:
        fpt.compile_plan(cql, {"S": fpt.StreamSchema(ID_FIELDS)})
    assert str(got.value) == str(ref.value)


# -- the zoo plans of this slice, at dryrun size ------------------------------

ZOO_FIELDS = {
    "S": [("id", "int"), ("name", "string"), ("price", "double"),
          ("timestamp", "long")],
    "Trades": [("sym", "string"), ("price", "double"), ("vol", "int"),
               ("timestamp", "long")],
}


def _zoo_data(n=600, seed=21):
    rng = np.random.default_rng(seed)
    # the streams interleaved so that each step's events come after the
    # step before's: the rows' order then does not depend on where a
    # drain falls (decode orders each drained block by timestamp)
    ts_s = 1000 + 3 * np.arange(n, dtype=np.int64)
    ts_t = 1001 + 3 * np.arange(n, dtype=np.int64)
    return {
        "S": {"id": rng.integers(0, 8, n).astype(np.int32),
              "name": np.asarray(["a", "b", "c"])[rng.integers(0, 3, n)],
              "price": rng.random(n) * 40.0, "timestamp": ts_s},
        "Trades": {"sym": np.asarray(["x", "y"])[rng.integers(0, 2, n)],
                   "price": rng.random(n) * 40.0,
                   "vol": rng.integers(0, 8, n).astype(np.int32),
                   "timestamp": ts_t},
    }


@pytest.mark.parametrize("name", ["window_join", "join_groupby_rewrite",
                                  "chained_composition"])
@pytest.mark.parametrize("mode", ["streaming", "fused", "resident"])
def test_zoo_plans_of_the_slice_give_the_reference_rows(name, mode):
    cql = PLAN_ZOO[name]
    data = _zoo_data()
    fields = {s: ZOO_FIELDS[s] for s in ("S", "Trades")}
    if name == "chained_composition":
        data, fields = {"S": data["S"]}, {"S": fields["S"]}
    ref = _rows("jax", cql, data, fields, 128, "out")
    kw = {"fused_segment_len": 4} if mode == "fused" else {
        "resident": mode == "resident"}
    got = _rows("torch", cql, data, fields, 128, "out", **kw)
    assert len(ref) > 50
    if name == "chained_composition":
        # window sums: the reference's are differences of running float32
        # sums (tests/torch_windows_common.py); the rest exactly
        assert len(got) == len(ref)
        np.testing.assert_allclose([r[0] for r in got],
                                   [r[0] for r in ref], rtol=1e-5)
    else:
        assert got == ref


def test_chained_refusals_keep_the_reference_messages():
    schemas = {"S": ID_FIELDS, "T": ID_FIELDS}
    cases = [
        # multiple producers of one chained stream
        "from S select id, price insert into mid; "
        "from T select id, price insert into mid; "
        "from mid select id insert into o",
        # a join over an intermediate stream
        "from S select id, price, timestamp insert into mid; "
        "from mid#window.length(2) as a join T#window.length(2) as b "
        "on a.id == b.id select a.id as i insert into o",
        # a pattern over an intermediate stream
        "from S select id, price insert into mid; "
        "from every a = mid[id == 1] -> b = mid[id == 2] "
        "select a.id as i insert into o",
        # an outer-join producer
        "from S#window.length(2) as a left outer join T#window.length(2) "
        "as b on a.id == b.id select a.id as i, b.price as p "
        "insert into mid; from mid select i insert into o",
        # a select * aggregated join
        "from S#window.length(2) as a join T#window.length(2) as b "
        "on a.id == b.id select * group by a.id insert into o",
    ]
    for cql in cases:
        with pytest.raises(JaxQLError) as ref:
            jax_compile(cql, {s: JaxSchema(f) for s, f in schemas.items()})
        with pytest.raises(SiddhiQLError) as got:
            fpt.compile_plan(
                cql, {s: fpt.StreamSchema(f) for s, f in schemas.items()})
        assert str(got.value) == str(ref.value)


def _tree_equal(ref, got, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            if k.startswith("kc_"):
                # a float running sum's compensation: the two packages
                # add in different orders; the compensated totals agree
                np.testing.assert_allclose(
                    (got[k[3:]].double() + got[k].double()).numpy(),
                    np.asarray(ref[k[3:]], np.float64)
                    + np.asarray(ref[k], np.float64), rtol=1e-6,
                    err_msg=f"{path}.{k}")
                continue
            _tree_equal(ref[k], got[k], f"{path}.{k}")
        return
    r, g = np.asarray(ref), got.numpy()
    assert r.dtype == g.dtype and r.shape == g.shape, path
    if r.dtype == np.float32:
        np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=path)
    else:
        assert np.array_equal(r, g), path


def test_join_and_chained_group_state_carry_across_packages():
    # join_groupby_rewrite stepped by both plans; after two steps the JAX
    # plan's state (the join's rings, the chained group tables @gv/@gc)
    # and its group encoder load into the port, which goes on equal
    import jax.numpy as jnp

    from flink_siddhi_tpu.runtime.tape import Tape as JaxTape
    from flink_siddhi_tpu.runtime.tape import build_tape as jax_build
    from flink_siddhi_tpu_torch.runtime.tape import build_tape as t_build

    cql = PLAN_ZOO["join_groupby_rewrite"]
    data = _zoo_data(n=512)
    plans, batches = [], []
    for schema_t, batch_t, compile_ in (
        (JaxSchema, JaxBatch, jax_compile),
        (fpt.StreamSchema, fpt.EventBatch, fpt.compile_plan),
    ):
        sch = {"S": schema_t(ZOO_FIELDS["S"])}
        sch["Trades"] = schema_t(
            ZOO_FIELDS["Trades"],
            shared_strings=sch["S"].string_tables["name"])
        plans.append(compile_(cql, sch))
        per = []
        for k in range(4):
            bs = []
            for sid in ("S", "Trades"):
                cols = {c: v[k * 128:(k + 1) * 128]
                        for c, v in data[sid].items()}
                for name, table in sch[sid].string_tables.items():
                    cols[name] = np.asarray(
                        [table.intern(str(v)) for v in cols[name]],
                        np.int32)
                bs.append(batch_t(sid, sch[sid], cols, cols["timestamp"]))
            per.append(bs)
        batches.append(per)
    jplan, tplan = plans
    assert list(tplan.chained) == list(jplan.chained)
    jst = jplan.init_state()
    tst = tplan.init_state("cpu")
    for k in range(4):
        jt, _ = jax_build(jplan.spec, batches[0][k], 1000, capacity=256)
        tt = t_build(tplan.spec, batches[1][k], 1000,
                     capacity=256).to(torch.device("cpu"))
        jst = jplan.grow_state(jst)
        if k == 2:
            encoders = {e.out_key: e.encoder.state_dict()
                        for e in jplan.spec.encoded}
            tst = fpt.state_from_numpy(
                tplan, {a: {kk: np.asarray(v) for kk, v in st.items()}
                        for a, st in jst.items()}, "cpu", encoders)
        tst = tplan.grow_state(tst)
        jst, jout = jplan.step(jst, JaxTape(
            jnp.asarray(jt.ts), jnp.asarray(jt.stream),
            jnp.asarray(jt.valid),
            {c: jnp.asarray(v) for c, v in jt.cols.items()}))
        tst, tout = tplan.step(tst, tt)
        _tree_equal(jst, tst)
        name = jplan.artifacts[1].name
        jm, jts, jc = jout[name]
        tm, tts, tc = tout[name]
        assert np.array_equal(np.asarray(jm), tm.numpy())
        m = np.asarray(jm)
        assert m.sum() > 0
        for a, b in zip(jc, tc):
            np.testing.assert_allclose(b.numpy()[m], np.asarray(a)[m],
                                       rtol=1e-6)
    assert "@gv" in tst[tplan.artifacts[1].name]


def test_unobserved_intermediate_streams_are_counted_not_decoded():
    # retention off, a sink on the output only: the intermediate stream's
    # rows are counted (the same counts as a retaining run), not decoded
    cql = PLAN_ZOO["chained_composition"]
    data = {"S": _zoo_data()["S"]}
    sch = fpt.StreamSchema(ZOO_FIELDS["S"])
    cols = dict(data["S"])
    cols["name"] = np.asarray([sch.string_tables["name"].intern(str(v))
                               for v in cols["name"]], np.int32)
    counts = []
    for retain in (True, False):
        plan = fpt.compile_plan(cql, {"S": sch})
        job = fpt.Job([plan], [fpt.BatchSource("S", sch, iter([
            fpt.EventBatch("S", sch, {k: v[i:i + 128]
                                      for k, v in cols.items()},
                           cols["timestamp"][i:i + 128])
            for i in range(0, len(cols["timestamp"]), 128)]))],
            batch_size=128, time_mode="processing", device="cpu",
            retain_results=retain)
        rows = []
        job.add_sink("out", lambda ts, row: rows.append((ts, row)))
        job.run()
        job.flush()
        counts.append((dict(job.emitted_counts), rows))
        if not retain:
            assert "mid" not in job.collected
    assert counts[0] == counts[1]
    assert counts[0][0]["mid"] > counts[0][0]["out"] // 2 > 0
