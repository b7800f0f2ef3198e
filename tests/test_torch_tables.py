"""Event tables in the torch port, held to the JAX package.

* The cases of ``tests/test_table_e2e.py`` run through both
  packages' APIs on the CPU, at several batch sizes, with equal rows (and
  the reference test's own rows at its batch size); the compile-time
  refusals carry the JAX package's text. Its windowed and aggregated
  table writes (and a ``timeBatch`` insert whose last window lands at the
  flush) leave the reference's rows and final table; a plan of them is
  stepped against the JAX plan, its state loaded mid-stream.
* ``TableMutateArtifact``, ``TableInsertArtifact`` and
  ``TableJoinArtifact`` (their kernels' plain versions on the CPU) equal
  the reference artifacts' ``step_tables`` bit for bit on the same tables
  and tapes: update and delete, the last writer winning, an ``on`` over an
  output-only column, a float condition, ring wrap-around and holes, a
  batch of more inserts than slots, the join's (i, j) order with outer
  rows after the pairs and the count past ``4 E``.
* A plan's table state carried from the JAX package mid-stream
  (``state_from_numpy``), a join on a string key through the shared
  string table, the segment body without a host read, and
  ``table_mutate_plain`` against a numpy oracle of the reference's dense
  formula.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_siddhi_tpu import CEPEnvironment as JaxEnv
from flink_siddhi_tpu import SiddhiCEP as JaxCEP
from flink_siddhi_tpu.compiler.config import EngineConfig as JaxConfig
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.tape import Tape as JaxTape
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler import cuda_ops
from flink_siddhi_tpu_torch.compiler import slot_program as sp
from flink_siddhi_tpu_torch.compiler.table import _on_words, table_key
from flink_siddhi_tpu_torch.query.lexer import SiddhiQLError
from flink_siddhi_tpu_torch.runtime.tape import Tape as TorchTape

torch.set_num_threads(2)


@dataclasses.dataclass
class Event:
    id: int
    kind: int
    price: float
    timestamp: int


FIELDS = ["id", "kind", "price", "timestamp"]
SCHEMA = [("id", "int"), ("kind", "int"), ("price", "double"),
          ("timestamp", "long")]
BATCHES = [1, 2, 4096]


def run_both(events, cql, batch_size, out="out"):
    """The port's rows (CPU) and the JAX package's, through each API; they
    must be equal. Returns the rows."""
    rows = []
    for cep, env in ((JaxCEP, JaxEnv(batch_size=batch_size)),
                     (fpt.SiddhiCEP,
                      fpt.CEPEnvironment(batch_size=batch_size,
                                         device="cpu"))):
        rows.append(cep.define("S", events, FIELDS, env=env).cql(cql)
                    .returns(out))
    ref, got = rows
    assert got == ref
    return got


# -- tests/test_table_e2e.py:32-172 -------------------------------------------

INSERT_JOIN = (
    "define table T (tid int, tprice double);"
    "from S[kind == 0] select id as tid, price as tprice insert into T;"
    "from S[kind == 1] join T on S.id == T.tid "
    "select S.id, T.tprice insert into out"
)


@pytest.mark.parametrize("batch_size", BATCHES)
def test_insert_then_join(batch_size):
    events = [
        Event(1, 0, 10.0, 1000),
        Event(2, 0, 20.0, 2000),
        Event(1, 1, 0.0, 3000),
        Event(2, 1, 0.0, 4000),
        Event(3, 1, 0.0, 5000),  # no table row -> no output
    ]
    out = run_both(events, INSERT_JOIN, batch_size)
    assert sorted(out) == [(1, 10.0), (2, 20.0)]


@pytest.mark.parametrize("batch_size", BATCHES)
def test_join_sees_same_batch_inserts(batch_size):
    events = [Event(5, 0, 55.0, 1000), Event(5, 1, 0.0, 2000)]
    out = run_both(
        events,
        "define table T (tid int, tprice double);"
        "from S[kind == 0] select id as tid, price as tprice insert into T;"
        "from S[kind == 1] join T on S.id == T.tid "
        "select T.tprice insert into out",
        batch_size,
    )
    assert out == [(55.0,)]


UPDATE = (
    "define table T (tid int, tprice double);"
    "from S[kind == 0] select id as tid, price as tprice insert into T;"
    "from S[kind == 2] select id as tid, price as tprice "
    "update T on T.tid == tid;"
    "from S[kind == 1] join T on S.id == T.tid "
    "select T.tprice insert into out"
)


@pytest.mark.parametrize("batch_size", BATCHES)
def test_update_on_condition(batch_size):
    events = [
        Event(1, 0, 10.0, 1000),  # insert id=1 price=10
        Event(1, 2, 99.0, 2000),  # update id=1 -> price=99
        Event(1, 1, 0.0, 3000),  # lookup
    ]
    out = run_both(events, UPDATE, batch_size)
    if batch_size == 1:  # the reference test's batch
        assert out == [(99.0,)]


@pytest.mark.parametrize("batch_size", BATCHES)
def test_delete_on_condition(batch_size):
    events = [
        Event(1, 0, 10.0, 1000),
        Event(2, 0, 20.0, 2000),
        Event(1, 3, 0.0, 3000),  # delete id=1
        Event(1, 1, 0.0, 4000),  # lookup id=1 -> gone
        Event(2, 1, 0.0, 5000),  # lookup id=2 -> present
    ]
    out = run_both(
        events,
        "define table T (tid int, tprice double);"
        "from S[kind == 0] select id as tid, price as tprice insert into T;"
        "from S[kind == 3] select id as tid delete T on T.tid == tid;"
        "from S[kind == 1] join T on S.id == T.tid "
        "select S.id, T.tprice insert into out",
        batch_size,
    )
    if batch_size == 1:
        assert out == [(2, 20.0)]


@pytest.mark.parametrize("batch_size", BATCHES)
def test_left_outer_table_join(batch_size):
    events = [
        Event(1, 0, 10.0, 1000),
        Event(1, 1, 0.0, 2000),
        Event(9, 1, 0.0, 3000),  # no row -> zero-filled table side
    ]
    out = run_both(
        events,
        "define table T (tid int, tprice double);"
        "from S[kind == 0] select id as tid, price as tprice insert into T;"
        "from S[kind == 1] left outer join T on S.id == T.tid "
        "select S.id, T.tprice insert into out",
        batch_size,
    )
    assert sorted(out) == [(1, 10.0), (9, 0.0)]


def _errors(cql, schemas=None):
    """Compile ``cql`` with both packages: (the JAX package's message, the
    port's), each None when it compiled."""
    out = []
    for compile_plan, schema_cls in ((jax_compile, JaxSchema),
                                     (fpt.compile_plan, fpt.StreamSchema)):
        try:
            compile_plan(cql, {"S": schema_cls(schemas or SCHEMA)})
            out.append(None)
        except Exception as e:  # each package's own SiddhiQLError
            assert type(e).__name__ == "SiddhiQLError", e
            out.append(str(e))
    return out


REFUSALS = {
    # the three refusal tests of tests/test_table_e2e.py
    "select_from_table": "define table T (tid int);"
                         "from T select tid insert into out",
    "table_table_join": "define table T (tid int); define table U (uid int);"
                        "from T join U on T.tid == U.uid "
                        "select T.tid insert into out",
    "table_preserving_outer_join": (
        "define table T (tid int, tprice double);"
        "from S[kind == 1] right outer join T on S.id == T.tid "
        "select S.id insert into out"),
    # compile_table_write / compile_table_join / plan.py's checks
    "unknown_table_column": "define table T (tid int);"
                            "from S select id as nope insert into T",
    "update_without_on": "define table T (tid int);"
                         "from S select id as tid update T",
    "output_neither_column_nor_on": (
        "define table T (tid int);"
        "from S select id as tid, price as zz update T on T.tid == tid"),
    "non_boolean_on": "define table T (tid int);"
                      "from S select id as tid update T on T.tid + tid",
    "window_on_table_side": (
        "define table T (tid int);"
        "from S join T#window.length(5) on S.id == T.tid "
        "select S.id insert into out"),
    "aggregation_over_table_join": (
        "define table T (tid int, tprice double);"
        "from S join T on S.id == T.tid "
        "select S.id, sum(T.tprice) as s group by S.id insert into out"),
    "rate_limited_table_write": (
        "define table T (tid int);"
        "from S select id as tid output every 5 events insert into T"),
    "update_target_not_a_table": "from S select id update X on X.id == id",
    "unknown_attribute_in_on": (
        "define table T (tid int);"
        "from S select id as tid delete T on T.nope == tid"),
    "non_boolean_join_on": (
        "define table T (tid int);"
        "from S join T on S.id + T.tid select S.id insert into out"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_carry_the_reference_text(case):
    ref, got = _errors(REFUSALS[case])
    assert ref is not None and got == ref


def test_table_refusal_citations():
    """The citations the reference pins (tests/test_table_e2e.py:118-170)."""
    _, msg = _errors(REFUSALS["table_table_join"])
    assert "table-table joins are not supported" in msg
    assert "siddhi-core 4.2.40" in msg
    assert "JoinInputStreamParser.parseInputStream" in msg
    _, msg = _errors(REFUSALS["table_preserving_outer_join"])
    assert "outer join preserving the table side is not supported" in msg
    assert "JoinInputStreamParser" in msg


# -- tests/test_table_e2e.py:173-357: windowed and aggregated writes -----------

SQ = {"S": [("id", "int"), ("price", "double"), ("timestamp", "long")],
      "Q": [("id", "int"), ("timestamp", "long")]}
KV = {"S": [("k", "int"), ("v", "double"), ("timestamp", "long")]}
WINDOWED = {
    # case: (schemas, cql, S columns, Q columns or None, batch)
    "aggregated_insert": (
        SQ,
        "define table Totals (id int, total double);"
        "from S select id, sum(price) as total group by id "
        "insert into Totals;"
        "from Q join Totals on Q.id == Totals.id "
        "select Q.id as qid, Totals.total as total insert into o",
        {"id": [1, 2, 1, 2, 1], "price": [1.0, 10.0, 2.0, 20.0, 3.0],
         "timestamp": [1000, 1001, 1002, 1003, 1004]},
        {"id": [1, 2], "timestamp": [2000, 2001]}, 16),
    "length_batch_insert": (
        SQ,
        "define table Sums (total double);"
        "from S#window.lengthBatch(3) select sum(price) as total "
        "insert into Sums;"
        "from Q join Sums select Q.id as qid, Sums.total as total "
        "insert into o",
        {"id": [0] * 6, "price": [1.0, 2.0, 3.0, 10.0, 20.0, 30.0],
         "timestamp": list(range(1000, 1006))},
        {"id": [9], "timestamp": [5000]}, 16),
    "windowed_update": (
        KV,
        "define table T (k int, total double);"
        "from S[timestamp < 1002] select k, 0.0 as total insert into T;"
        "from S#window.lengthBatch(4) select k, sum(v) as total group by k "
        "update T on T.k == k",
        {"k": [0, 1, 0, 1, 0, 1, 0, 1],
         "v": [1.0, 10.0, 2.0, 20.0, 4.0, 40.0, 8.0, 80.0],
         "timestamp": list(range(1000, 1008))}, None, 8),
    "windowed_delete": (
        KV,
        "define table T (k int);"
        "from S[timestamp < 1002] select k insert into T;"
        "from S#window.lengthBatch(4) select k, count() as c group by k "
        "having c > 2 delete T on T.k == k",
        {"k": [0, 1, 0, 0, 1, 0, 0, 0], "v": [1.0] * 8,
         "timestamp": list(range(1000, 1008))}, None, 8),
    # a timeBatch window's last window reaches the table only at the flush
    "time_batch_insert_flushes": (
        KV,
        "define table T (k int, total double);"
        "from S#window.timeBatch(4 ms) select k, sum(v) as total group by k "
        "insert into T",
        {"k": [0, 1, 0, 1, 0, 1, 0, 1, 0, 1],
         "v": [1.0, 10.0, 2.0, 20.0, 4.0, 40.0, 8.0, 80.0, 16.0, 160.0],
         "timestamp": list(range(1000, 1010))}, None, 4),
}
# what tests/test_table_e2e.py asserts of each (the flush case: its three
# windows of two keys, the last one landed by the flush)
WINDOWED_EXPECT = {
    "aggregated_insert": lambda rows, tbl: (
        max(t for q, t in rows if q == 1) == 6.0
        and max(t for q, t in rows if q == 2) == 30.0),
    "length_batch_insert": lambda rows, tbl: (
        sorted(t for _, t in rows) == [6.0, 60.0]),
    "windowed_update": lambda rows, tbl: (
        dict(zip(tbl["k"], tbl["total"])) == {0: 12.0, 1: 120.0}),
    "windowed_delete": lambda rows, tbl: tbl["k"] == [1],
    "time_batch_insert_flushes": lambda rows, tbl: (
        sorted(zip(tbl["k"], tbl["total"])) == [
            (0, 3.0), (0, 12.0), (0, 16.0), (1, 30.0), (1, 120.0),
            (1, 160.0)]),
}


def _run_windowed(pkg, case):
    """The case's Job in one package (the port on the CPU): its ``o`` rows
    and its final table's valid rows, column by column."""
    schemas, cql, s_cols, q_cols, batch = WINDOWED[case]
    if pkg == "jax":
        from flink_siddhi_tpu.runtime.executor import Job
        from flink_siddhi_tpu.runtime.sources import BatchSource
        from flink_siddhi_tpu.schema.batch import EventBatch
        Schema, compile_plan, kw = JaxSchema, jax_compile, {}
    else:
        Job, BatchSource, EventBatch = fpt.Job, fpt.BatchSource, fpt.EventBatch
        Schema, compile_plan, kw = fpt.StreamSchema, fpt.compile_plan, {
            "device": "cpu"}
    sch = {sid: Schema(f) for sid, f in schemas.items()}
    sources = []
    for sid, cols in (("S", s_cols), ("Q", q_cols)):
        if cols is None:
            continue
        fields = dict(schemas[sid])
        arrs = {k: np.asarray(v, np.int64 if fields[k] == "long" else
                              np.int32 if fields[k] == "int" else
                              np.float64) for k, v in cols.items()}
        ts = arrs["timestamp"]
        sources.append(BatchSource(sid, sch[sid], iter([
            EventBatch(sid, sch[sid], {k: v[s:s + batch]
                                       for k, v in arrs.items()},
                       ts[s:s + batch])
            for s in range(0, len(ts), batch)])))
    plan = compile_plan(cql, sch)
    job = Job([plan], sources, batch_size=batch, time_mode="processing",
              **kw)
    job.run()
    rows = job.results("o") if q_cols is not None else []
    (rt,) = job._plans.values()
    tid = next(iter(rt.states["@tables"]))
    tstate = {k: np.asarray(v) for k, v in rt.states["@tables"][tid].items()}
    valid = tstate["valid"]
    tbl = {k.split(".", 1)[1]: v[valid].tolist()
           for k, v in tstate.items() if k.startswith("@tbl:")}
    return rows, tbl, plan


@pytest.mark.parametrize("case", sorted(WINDOWED))
def test_windowed_table_writes_match_the_reference(case):
    ref_rows, ref_tbl, _ = _run_windowed("jax", case)
    rows, tbl, plan = _run_windowed("torch", case)
    assert rows == ref_rows and tbl == ref_tbl
    assert WINDOWED_EXPECT[case](rows, tbl)
    kinds = {type(a).__name__ for a in plan.artifacts}
    if case.startswith("windowed_"):  # the rewrite: window, then K6
        assert kinds == {"BatchWindowArtifact", "TableInsertArtifact",
                         "TableMutateArtifact"}
    else:
        assert "WindowedTableInsertArtifact" in kinds


def test_time_batch_table_insert_lands_its_last_window_at_the_flush():
    schemas, cql, s_cols, _, _ = WINDOWED["time_batch_insert_flushes"]
    plan = fpt.compile_plan(cql, {"S": fpt.StreamSchema(schemas["S"])})
    assert plan.has_flush
    job = fpt.Job([plan], [fpt.BatchSource(
        "S", plan.schemas["S"], iter([fpt.EventBatch(
            "S", plan.schemas["S"],
            {"k": np.asarray(s_cols["k"], np.int32),
             "v": np.asarray(s_cols["v"]),
             "timestamp": np.asarray(s_cols["timestamp"], np.int64)},
            np.asarray(s_cols["timestamp"], np.int64))]))],
        batch_size=16, time_mode="processing", device="cpu")
    while not job.finished:  # the whole stream, nothing flushed yet
        job.run_cycle()
    (rt,) = job._plans.values()
    before = int(rt.states["@tables"]["T"]["valid"].sum())
    job.flush()
    assert (before, int(rt.states["@tables"]["T"]["valid"].sum())) == (4, 6)


WINDOWED_PLAN = (
    "define table T (tid int, tprice double, tag int);"
    "from S[kind == 0]#window.lengthBatch(16) select id as tid, "
    "sum(price) as tprice, count() as tag group by id insert into T;"
    "from S[kind == 1] select id as tid, sum(price) as tprice group by id "
    "insert into T;"
    "from S[kind == 2]#window.length(8) select id as tid, avg(price) as "
    "tprice group by id update T on T.tid == tid;"
    "from S[kind == 0] join T on S.id == T.tid "
    "select S.id as i, T.tprice as tp, T.tag as tg insert into out"
)


def _tree_close(ref, got, path=""):
    """Ints and bools exact, floats within rtol 1e-5 (window sums); a
    running sum's compensation ``kc_<sum>`` is compared added to its sum,
    the value they stand for."""
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            if k.startswith("kc_"):
                b = k[3:]
                np.testing.assert_allclose(
                    got[b].double().numpy() + got[k].double().numpy(),
                    np.asarray(ref[b], np.float64) + np.asarray(ref[k]),
                    rtol=1e-5, atol=1e-6, err_msg=f"{path}.{k}")
                continue
            _tree_close(ref[k], got[k], f"{path}.{k}")
        return
    r, g = np.asarray(ref), got.numpy()
    assert r.dtype == g.dtype and r.shape == g.shape, path
    if r.dtype.kind == "f":
        np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=path)
    else:
        assert np.array_equal(r, g), path


@pytest.mark.parametrize("load_at", [None, 2])
def test_windowed_plan_state_carries_across_packages(load_at):
    """A plan of windowed and aggregated inserts, a windowed update (its
    synthesized stream and K6's plain version) and a table join, stepped
    against the JAX plan; the JAX state (each windowed insert's nested
    ``win`` state, its ``overflow``, the encoders) loaded mid-stream."""
    jplan, tplan = _plans(WINDOWED_PLAN, table_capacity=32)
    rng = np.random.default_rng(12)
    jst, tst = jplan.init_state(), tplan.init_state("cpu")
    encs = [(je.encoder, te.encoder)
            for je, te in zip(jplan.spec.encoded, tplan.spec.encoded)]
    assert len(encs) == 3
    for k in range(4):
        ts, stream, valid, cols = _tape(rng, 128, n_ids=40)
        jcols, tcols = dict(cols), dict(cols)
        for (je, te), jenc, tenc in zip(
                encs, jplan.spec.encoded, tplan.spec.encoded):
            # each query's group codes, over its own filter's events
            sel = valid & tenc.select_fn(
                {c: v for c, v in cols.items() if c != "S.timestamp"})
            jcols[jenc.out_key] = je.intern_rows([cols["S.id"]], sel)
            tcols[tenc.out_key] = te.intern_rows([cols["S.id"]], sel)
        jt, _ = _tapes_of((ts, stream, valid, jcols))
        _, tt = _tapes_of((ts, stream, valid, tcols))
        jst, tst = jplan.grow_state(jst), tplan.grow_state(tst)
        if k == load_at:
            tst = fpt.state_from_numpy(
                tplan, jax_tree_np(jst), "cpu",
                {e.out_key: e.encoder.state_dict()
                 for e in jplan.spec.encoded})
        jst, jout = jax.jit(jplan.step)(jst, jt)
        tst, tout = tplan.step(tst, tt)
        _tree_close(jst, tst)
    assert bool(tst["@tables"]["T"]["valid"].any())
    assert any(isinstance(v, dict) and "win" in v for v in tst.values())


def test_call_over_both_sides_names_its_item():
    cql = ("define table T (tid int, tprice double);"
           "from S join T on math:abs(S.price - T.tprice) < 1.0 "
           "select S.id insert into out")
    jax_compile(cql, {"S": JaxSchema(SCHEMA)})
    with pytest.raises(SiddhiQLError, match="item 8"):
        fpt.compile_plan(cql, {"S": fpt.StreamSchema(SCHEMA)})


# -- artifacts against the reference's step_tables ------------------------------

def _tape(rng, E, n_ids=8, kinds=3, m=None):
    """A stream S tape of ``E`` positions (the first ``m`` valid): numpy
    columns for both packages."""
    m = E if m is None else m
    ts = np.sort(rng.integers(0, 4 * E, E)).astype(np.int32)
    valid = np.arange(E) < m
    stream = np.where(valid, 0, -1).astype(np.int32)
    price = (rng.random(E) * 100).astype(np.float32)
    price[rng.random(E) < 0.1] = 50.0  # ties for the float conditions
    cols = {"S.id": rng.integers(0, n_ids, E).astype(np.int32),
            "S.kind": rng.integers(0, kinds, E).astype(np.int32),
            "S.price": price,
            "S.timestamp": ts + 1000}
    return ts, stream, valid, cols


def _tapes_of(t):
    ts, stream, valid, cols = t
    jt = JaxTape(jnp.asarray(ts), jnp.asarray(stream), jnp.asarray(valid),
                 {c: jnp.asarray(v) for c, v in cols.items()})
    tt = TorchTape(torch.from_numpy(ts), torch.from_numpy(stream),
                   torch.from_numpy(valid),
                   {c: torch.from_numpy(v) for c, v in cols.items()})
    return jt, tt


def _table(rng, tid, C, n_ids=8, fill=0.7, ptr=None):
    """Random table state (numpy): ``valid`` with holes, columns tid, tprice,
    tag."""
    return {
        "valid": rng.random(C) < fill,
        "ptr": np.asarray(rng.integers(0, C) if ptr is None else ptr,
                          np.int32),
        table_key(tid, "tid"): rng.integers(0, n_ids, C).astype(np.int32),
        table_key(tid, "tprice"): (rng.random(C) * 100).astype(np.float32),
        table_key(tid, "tag"): rng.integers(-5, 5, C).astype(np.int32),
    }


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


TABLE = "define table T (tid int, tprice double, tag int);"
MUTATE_CASES = {
    "update": "from S[kind == 1] select id as tid, price as tprice "
              "update T on T.tid == tid",
    "delete": "from S[kind == 1] select id as tid delete T on T.tid == tid",
    # an output that only feeds `on` is not written
    "update_output_only_on": "from S[kind == 1] select id as k, price as "
                             "tprice, kind + 3 as tag update T on "
                             "T.tid == k and T.tag < k",
    "update_float_condition": "from S[kind != 0] select price as tprice "
                              "update T on T.tprice < price",
    "delete_float_condition": "from S select price as p delete T on "
                              "T.tprice > p * 1.5 or T.tprice == p",
    "update_stream_and_output": "from S[kind == 2] select id as tid, "
                                "price * 2.0 as tprice update T on "
                                "T.tid == S.id and tprice > T.tprice",
    # a call over one side is a derived column of that side
    "delete_calls_over_each_side": "from S[kind == 1] select id as tid "
                                   "delete T on math:abs(T.tag) == tid "
                                   "or T.tid == math:abs(S.id - 4)",
}


def _plans(cql, **cfg):
    jplan = jax_compile(cql, {"S": JaxSchema(SCHEMA)},
                        config=JaxConfig(**cfg))
    tplan = fpt.compile_plan(cql, {"S": fpt.StreamSchema(SCHEMA)},
                             config=fpt.EngineConfig(**cfg))
    return jplan, tplan


@pytest.mark.parametrize("case", sorted(MUTATE_CASES))
@pytest.mark.parametrize("E,C", [(64, 16), (700, 128)])
def test_mutate_step_matches_the_reference(case, E, C):
    jplan, tplan = _plans(TABLE + MUTATE_CASES[case], table_capacity=C)
    jart, tart = jplan.artifacts[0], tplan.artifacts[0]
    assert type(tart).__name__ == "TableMutateArtifact"
    rng = np.random.default_rng(E + C + len(case))
    for _ in range(3):
        tbl = _table(rng, "T", C)
        jt, tt = _tapes_of(_tape(rng, E, m=E - E // 8))
        jst, jtabs, _ = jart.step_tables(
            jart.init_state(), {"T": {k: jnp.asarray(v)
                                      for k, v in tbl.items()}}, jt)
        tst, ttabs, (tn, _, _) = tart.step_tables(
            tart.init_state("cpu"), {"T": {k: torch.from_numpy(v.copy())
                                           for k, v in tbl.items()}}, tt)
        _assert_tree_equal(jtabs, ttabs)
        _assert_tree_equal(jst, tst)
        assert int(tn) == 0
        changed = sum(not np.array_equal(np.asarray(jtabs["T"][k]), v)
                      for k, v in tbl.items())
        assert changed  # the case mutates something


def test_update_last_writer_wins():
    """Many events a row: each matched row takes the LAST matching event's
    values (tape order), as the reference."""
    jplan, tplan = _plans(TABLE + MUTATE_CASES["update"], table_capacity=8)
    rng = np.random.default_rng(3)
    tbl = _table(rng, "T", 8, n_ids=3, fill=1.0)
    t = _tape(rng, 200, n_ids=3, kinds=2)
    jt, tt = _tapes_of(t)
    jst, jtabs, _ = jplan.artifacts[0].step_tables(
        {"enabled": jnp.asarray(True)},
        {"T": {k: jnp.asarray(v) for k, v in tbl.items()}}, jt)
    _, ttabs, _ = tplan.artifacts[0].step_tables(
        {"enabled": torch.tensor(True)},
        {"T": {k: torch.from_numpy(v.copy()) for k, v in tbl.items()}}, tt)
    _assert_tree_equal(jtabs, ttabs)
    ts, _, _, cols = t
    upd = np.flatnonzero(cols["S.kind"] == 1)
    got = ttabs["T"][table_key("T", "tprice")].numpy()
    for j, tid in enumerate(tbl[table_key("T", "tid")]):
        hits = upd[cols["S.id"][upd] == tid]
        assert len(hits) > 1
        assert got[j] == cols["S.price"][hits[-1]]


INSERT = TABLE + ("from S[kind == 0] select id as tid, price as tprice, "
                  "kind as tag insert into T")


@pytest.mark.parametrize("E,C,m,ptr,fill", [
    (64, 16, 40, 3, 0.5),  # more inserts than slots in one batch
    (64, 16, 9, 13, 0.5),  # wraps past the ring's end
    (64, 32, 10, 5, 0.3),  # holes before the pointer stay holes
    (300, 128, 300, 127, 0.9),
    (16, 16, 0, 7, 0.5),  # nothing inserted
])
def test_ring_append_matches_the_reference(E, C, m, ptr, fill):
    jplan, tplan = _plans(INSERT, table_capacity=C)
    jart, tart = jplan.artifacts[0], tplan.artifacts[0]
    rng = np.random.default_rng(E + C + m)
    tbl = _table(rng, "T", C, fill=fill, ptr=ptr)
    ts, stream, valid, cols = _tape(rng, E, kinds=1, m=m)
    jt, tt = _tapes_of((ts, stream, valid, cols))
    jst = {"enabled": jnp.asarray(True), "overflow": jnp.asarray(5,
                                                                 jnp.int32)}
    tst = {"enabled": torch.tensor(True),
           "overflow": torch.tensor(5, dtype=torch.int32)}
    for _ in range(2):
        jst, jtabs, _ = jart.step_tables(
            jst, {"T": {k: jnp.asarray(v) for k, v in tbl.items()}}, jt)
        tst, ttabs, _ = tart.step_tables(
            tst, {"T": {k: torch.from_numpy(v.copy())
                        for k, v in tbl.items()}}, tt)
        _assert_tree_equal(jtabs, ttabs)
        _assert_tree_equal(jst, tst)
        tbl = {k: np.asarray(v) for k, v in jtabs["T"].items()}
    assert int(tst["overflow"]) == 5 + 2 * max(m - C, 0)
    assert int(ttabs["T"]["ptr"]) == (ptr + 2 * m) % C


JOIN_CASES = {
    # no `on` over a full table: every (event, slot) pair, past 4 E
    "no_on_full_table": (TABLE + "from S join T select S.id, T.tid, "
                         "T.tprice insert into out", 1.0),
    "inner": (TABLE + "from S[kind == 1] join T on S.id == T.tid "
              "select S.id as i, S.price as p, T.tprice as tp, T.tag as g "
              "insert into out", 0.7),
    "left_outer": (TABLE + "from S left outer join T on S.id == T.tid and "
                   "T.tprice > S.price select S.id, T.tprice, "
                   "S.price + T.tprice as s insert into out", 0.7),
    "right_outer_stream_side": (
        TABLE + "from T right outer join S[kind != 2] on T.tid == S.id "
        "select S.id, T.tag insert into out", 0.4),
    "calls_over_each_side": (
        TABLE + "from S join T on math:abs(T.tag) == S.id and "
        "T.tprice < math:abs(S.price - 50.0) select S.id, T.tag "
        "insert into out", 0.9),
}


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_table_join_step_matches_the_reference(case):
    cql, fill = JOIN_CASES[case]
    E, C = 96, 8
    jplan, tplan = _plans(cql, table_capacity=C)
    jart, tart = jplan.artifacts[0], tplan.artifacts[0]
    assert type(tart).__name__ == "TableJoinArtifact"
    rng = np.random.default_rng(len(case))
    jst, tst = jart.init_state(), tart.init_state("cpu")
    for _ in range(2):
        tbl = _table(rng, "T", C, fill=fill)
        jt, tt = _tapes_of(_tape(rng, E, m=E - 5))
        tabs_j = {"T": {k: jnp.asarray(v) for k, v in tbl.items()}}
        tabs_t = {"T": {k: torch.from_numpy(v.copy())
                        for k, v in tbl.items()}}
        jst, _, (jn, jts, jcols) = jart.step_tables(jst, tabs_j, jt)
        tst, _, (tn, tts, tcols) = tart.step_tables(tst, tabs_t, tt)
        n = int(jn)
        assert int(tn) == n and n > 0
        assert np.array_equal(np.asarray(jts)[:n], tts.numpy()[:n])
        for a, b in zip(jcols, tcols):
            _assert_tree_equal(np.asarray(a)[:n], b[:n])
        _assert_tree_equal(jst, tst)
    if case == "no_on_full_table":
        assert int(tst["overflow"]) == 2 * ((E - 5) * C - 4 * E)


def test_table_join_order_pairs_then_outer_rows():
    """The pair rows in (i, j) slot order, every outer row after them."""
    cql, _ = JOIN_CASES["left_outer"]
    _, tplan = _plans(cql, table_capacity=8)
    art = tplan.artifacts[0]
    rng = np.random.default_rng(1)
    tbl = {k: torch.from_numpy(v) for k, v in
           _table(rng, "T", 8, fill=0.6).items()}
    _, tt = _tapes_of(_tape(rng, 64))
    a_cols, b_cols = _on_words(art.on, art.derived, dict(tt.cols), tbl, tt.ts,
                               tbl["valid"])
    d = cuda_ops.table_join_dir(tt.valid, a_cols, tbl["valid"], b_cols,
                                art.on.code, art.on.depth, True)
    pi, pj, seg, n = cuda_ops.join_pairs([d], tt.ts, 256, False, None)
    n = int(n[0])
    pi, pj, seg = pi[:n].numpy(), pj[:n].numpy(), seg[:n].numpy()
    k = int((seg == 0).sum())
    assert 0 < k < n and (seg[:k] == 0).all() and (seg[k:] == 1).all()
    key = pi[:k].astype(np.int64) * 8 + pj[:k]
    assert (np.diff(key) > 0).all()
    assert (np.diff(pi[k:]) > 0).all()
    assert not set(pi[k:]) & set(pi[:k])


# -- whole plans -----------------------------------------------------------------

PLAN = (
    "define table T (tid int, tprice double, tag int);"
    "from S[kind == 0] select id as tid, price as tprice, kind as tag "
    "insert into T;"
    "from S[kind == 1 and price < 50.0] select id as tid, price as tprice "
    "update T on T.tid == tid;"
    "from S[kind == 1 and price > 90.0] select id as tid delete T on "
    "T.tid == tid;"
    "from S[kind == 2] left outer join T on S.id == T.tid "
    "select S.id as i, S.price as p, T.tprice as tp insert into out"
)


def _plan_step_both(cql, tapes, load_at=None, **cfg):
    """Step both plans over ``tapes``; the port's state is loaded from the
    JAX plan's (``state_from_numpy``) before tape ``load_at``. Returns the
    join's row count."""
    jplan, tplan = _plans(cql, **cfg)
    jst, tst = jplan.init_state(), tplan.init_state("cpu")
    rows = 0
    for k, t in enumerate(tapes):
        if k == load_at:
            np_state = jax_tree_np(jst)
            tst = fpt.state_from_numpy(tplan, np_state, "cpu")
        jt, tt = _tapes_of(t)
        jst, jout = jplan.step(jst, jt)
        tst, tout = tplan.step(tst, tt)
        _assert_tree_equal(jst, tst)
        for a in tplan.artifacts:
            jn, jts, jcols = jout[a.name]
            tn, tts, tcols = tout[a.name]
            n = int(jn)
            assert int(tn) == n
            assert np.array_equal(np.asarray(jts)[:n], tts.numpy()[:n])
            for x, y in zip(jcols, tcols):
                _assert_tree_equal(np.asarray(x)[:n], y[:n])
            rows += n
    return rows, tst


def jax_tree_np(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_np(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("E", [32, 512])
def test_plan_steps_match_the_reference(E):
    rng = np.random.default_rng(E)
    tapes = [_tape(rng, E, n_ids=E // 8) for _ in range(4)]
    rows, tst = _plan_step_both(PLAN, tapes, table_capacity=16)
    assert rows > 0 and bool(tst["@tables"]["T"]["valid"].any())


def test_jax_table_state_loads_mid_stream():
    rng = np.random.default_rng(5)
    tapes = [_tape(rng, 128, n_ids=12) for _ in range(4)]
    rows, _ = _plan_step_both(PLAN, tapes, load_at=2, table_capacity=16)
    assert rows > 0


def test_join_on_a_string_key():
    @dataclasses.dataclass
    class Named:
        name: str
        kind: int
        price: float
        timestamp: int

    names = ["ab", "cd", "ef", "gh"]
    rng = np.random.default_rng(2)
    events = [Named(names[int(rng.integers(0, 4))], int(rng.integers(0, 3)),
                    float(i), 1000 + i) for i in range(60)]
    cql = ("define table T (name string, v double);"
           "from S[kind == 0] select name, price as v insert into T;"
           "from S[kind == 1] select name delete T on T.name == S.name "
           "and T.name != 'gh';"
           "from S[kind == 2] join T on S.name == T.name "
           "select S.price as p, T.name as n, T.v as v insert into out")
    fields = ["name", "kind", "price", "timestamp"]
    for batch_size in (7, 4096):
        rows = []
        for cep, env in ((JaxCEP, JaxEnv(batch_size=batch_size)),
                         (fpt.SiddhiCEP,
                          fpt.CEPEnvironment(batch_size=batch_size,
                                             device="cpu"))):
            rows.append(cep.define("S", events, fields, env=env).cql(cql)
                        .returns("out"))
        assert rows[1] == rows[0] and len(rows[0]) > 10
        assert {r[1] for r in rows[0]} <= set(names)


def test_segment_body_makes_no_host_read(monkeypatch):
    """The table step (insert, K6's update and delete, the join on K5)
    reads nothing on the host, what a CUDA graph could not capture: the
    segment body under the host-read guard of tests/test_torch_segments.py,
    with the kernels' plain versions (which may read on the host) run with
    the guard paused and their outputs marked derived."""
    from test_torch_segments import HostReadGuard

    from flink_siddhi_tpu_torch.runtime.graphs import step_segment

    rng = np.random.default_rng(9)
    schema = fpt.StreamSchema(SCHEMA)
    batches = []
    for b in range(3):
        ts, _, _, cols = _tape(rng, 256, n_ids=12)
        ts = ts.astype(np.int64) + 1024 * b
        batches.append(fpt.EventBatch(
            "S", schema, {"id": cols["S.id"], "kind": cols["S.kind"],
                          "price": cols["S.price"].astype(np.float64),
                          "timestamp": ts}, ts))
    plan = fpt.compile_plan(PLAN, {"S": schema},
                            config=fpt.EngineConfig(table_capacity=16))
    job = fpt.Job([plan], [fpt.BatchSource("S", schema, iter(batches))],
                  batch_size=256, time_mode="processing",
                  retain_results=False, device="cpu")
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
    calls = {"table_mutate": 0, "join_pairs": 0}

    def paused(name):
        real = getattr(cuda_ops, name)

        def call(*args, **kwargs):
            calls[name] += 1
            guard.paused = True
            try:
                out = real(*args, **kwargs)
            finally:
                guard.paused = False
            for t in (out if isinstance(out, tuple) else (out,)):
                guard._mark(t)
            return out
        monkeypatch.setattr(cuda_ops, name, call)

    paused("table_mutate")
    paused("join_pairs")
    with guard:
        states, acc = step_segment(rt.plan, rt.states, rt.acc, tapes)
    assert calls == {"table_mutate": 2 * len(tapes),
                     "join_pairs": len(tapes)}
    assert int(acc["meta"][0].sum()) > 0
    assert bool(states["@tables"]["T"]["valid"].any())


def test_resident_and_fused_rows_equal_streaming_rows():
    """The tables plan through ResidentReplay and the fused streaming Job
    (segments of the graph path's body, on the CPU) emits the streaming
    Job's rows and leaves its table."""
    schema = fpt.StreamSchema(SCHEMA)

    def batches():
        out = []
        r = np.random.default_rng(4)
        for b in range(4):
            ts, _, _, cols = _tape(r, 200, n_ids=12)
            ts = ts.astype(np.int64) + 1000 * b
            out.append(fpt.EventBatch(
                "S", schema, {"id": cols["S.id"], "kind": cols["S.kind"],
                              "price": cols["S.price"].astype(np.float64),
                              "timestamp": ts}, ts))
        return out

    res = []
    for mode in ("streaming", "resident", "fused"):
        plan = fpt.compile_plan(PLAN, {"S": schema},
                                config=fpt.EngineConfig(table_capacity=16))
        job = fpt.Job([plan], [fpt.BatchSource("S", schema,
                                               iter(batches()))],
                      batch_size=200, time_mode="processing", device="cpu")
        if mode == "resident":
            rep = fpt.ResidentReplay(job)
            rep.stage()
            rep.run()
        else:
            job.fused_segment_len = 4 if mode == "fused" else None
            job.run()
        job.flush()
        tbl = job._plans["plan"].states["@tables"]["T"]
        res.append((job.results_with_ts("out"),
                    {k: v.tolist() for k, v in tbl.items()}))
        assert job.eager_segments == 0
    assert res[0] == res[1] == res[2] and len(res[0][0]) > 50


# -- the plain versions --------------------------------------------------------

def _oracle_last(mask, valid, match):
    """The reference's formula in numpy: last matching event per row."""
    m = mask[:, None] & valid[None, :] & match
    E = m.shape[0]
    hit = m.any(axis=0)
    last = (E - 1) - np.argmax(m[::-1, :], axis=0)
    return np.where(hit, last, -1).astype(np.int32)


@pytest.mark.parametrize("E,C", [(1, 1), (300, 64), (2500, 40)])
def test_table_mutate_plain_matches_numpy(E, C, monkeypatch):
    rng = np.random.default_rng(E)
    # a.id == b.id and a.price < b.price (a float condition after the key)
    prog = (sp.OP_EVT, sp.OP_CAP, sp.OP_EQ_I, sp.OP_ANDJ | 4 << 8,
            sp.OP_EVT | 1 << 8, sp.OP_CAP | 1 << 8, sp.OP_LT_F, sp.OP_AND)
    ids, bids = rng.integers(0, 5, E), rng.integers(0, 5, C)
    px = (rng.random(E) * 10).astype(np.float32)
    bpx = (rng.random(C) * 10).astype(np.float32)
    mask, valid = rng.random(E) < 0.6, rng.random(C) < 0.8
    a_cols = np.stack([ids.astype(np.int32), px.view(np.int32)])
    b_cols = np.stack([bids.astype(np.int32), bpx.view(np.int32)])
    monkeypatch.setattr(cuda_ops, "_PLAIN_CHUNK_CELLS", 1000)  # chunks
    got = cuda_ops.table_mutate(
        torch.from_numpy(mask), torch.from_numpy(a_cols),
        torch.from_numpy(valid), torch.from_numpy(b_cols), prog, 2)
    match = (ids[:, None] == bids[None, :]) & (px[:, None] < bpx[None, :])
    assert np.array_equal(got.numpy(), _oracle_last(mask, valid, match))
    none = cuda_ops.table_mutate_plain(
        torch.from_numpy(mask), torch.from_numpy(a_cols),
        torch.from_numpy(valid), torch.from_numpy(b_cols), (), 0)
    assert np.array_equal(none.numpy(), _oracle_last(
        mask, valid, np.ones((E, C), bool)))


def test_table_join_dir_is_every_valid_slot():
    """K5's plain version on a table direction: each event meets every
    valid slot, in slot order."""
    rng = np.random.default_rng(0)
    E, C = 20, 6
    mask, valid = rng.random(E) < 0.7, rng.random(C) < 0.6
    d = cuda_ops.table_join_dir(
        torch.from_numpy(mask), torch.zeros((0, E), dtype=torch.int32),
        torch.from_numpy(valid), torch.zeros((0, C), dtype=torch.int32),
        (), 0, False)
    pi, pj, seg, n = cuda_ops.join_pairs(
        [d], torch.arange(E, dtype=torch.int32), 4 * E, False, None)
    want = [(i, j) for i in range(E) if mask[i] for j in range(C)
            if valid[j]]
    n = int(n[0])
    assert n == len(want)
    got = list(zip(pi[:n].tolist(), pj[:n].tolist()))
    assert got == want[:4 * E] and not seg[:n].any()


def test_table_join_dir_shares_its_fixed_tensors():
    """A table direction's fixed window tensors are made once a (E, C,
    device) and left as they were by a join over them; the table's own
    tensors are the caller's."""
    rng = np.random.default_rng(3)
    E, C = 16, 5
    dirs = []
    for _ in range(2):
        mask, valid = rng.random(E) < 0.5, rng.random(C) < 0.5
        dirs.append(cuda_ops.table_join_dir(
            torch.from_numpy(mask), torch.zeros((0, E), dtype=torch.int32),
            torch.from_numpy(valid), torch.zeros((0, C), dtype=torch.int32),
            (), 0, True))
        cuda_ops.join_pairs(dirs[-1:], torch.arange(E, dtype=torch.int32),
                            4 * E, False, None)
    a, b = dirs
    for f in ("b_ts", "b_posid", "b_cum", "b_seen"):
        assert getattr(a, f) is getattr(b, f)
    assert a.b_valid is not b.b_valid
    assert (a.b_ts == 0).all() and (a.b_posid == -1).all()
    assert (a.b_cum == C).all() and a.b_seen.tolist() == [C]
    other = cuda_ops.table_join_dir(
        a.a_mask[:E - 1], torch.zeros((0, E - 1), dtype=torch.int32),
        a.b_valid, a.b_cols, (), 0, False)
    assert other.b_cum is not a.b_cum and other.b_cum.shape == (E - 1,)


# -- `on` programs deeper than a thread's local stack ------------------------------

def _deep(attr: str, n: int) -> str:
    """``attr + (attr + (... attr))``: a program ``n`` + 1 values deep."""
    e = attr
    for _ in range(n):
        e = f"({attr} + {e})"
    return e


DEEP = {
    "table_update": (
        "define table T (tid int, tprice double);"
        "from S[kind == 0] select id as tid, price as tprice insert into T;"
        "from S[kind == 2] select id as tid, price as tprice update T on "
        "T.tid == tid and T.tprice * 300.0 > " + _deep("tprice", 240) + ";"
        "from S[kind == 1] join T on S.id == T.tid "
        "select S.id as i, T.tprice as tp insert into out"),
    "stream_join": (
        "from S[kind == 0]#window.length(6) as a join "
        "S[kind == 1]#window.length(6) as b on a.id == b.id and "
        "a.price * 300.0 > " + _deep("b.price", 240) +
        " select a.id as i, a.price as pa, b.price as pb insert into out"),
}


@pytest.mark.parametrize("case", sorted(DEEP))
def test_deep_on_programs_give_the_reference_rows(case):
    """An ``on`` program 243 values deep (past the kernels' 227-word local
    stacks; on the card it takes their global stack) runs on the CPU
    through the plain path and gives the JAX package's rows."""
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(20000)  # both parsers recurse per parenthesis
    try:
        schema = fpt.StreamSchema(SCHEMA)
        plan = fpt.compile_plan(DEEP[case], {"S": schema})
        depths = [p.depth for a in plan.artifacts
                  for p in ([a.on] if hasattr(a, "on") else
                            (getattr(a, "on_progs", None) or {}).values())]
        assert max(depths) > 227
        rng = np.random.default_rng(31)
        events = [Event(int(rng.integers(0, 6)), int(rng.integers(0, 3)),
                        float(np.round(rng.random() * 10, 1)), 1000 + i)
                  for i in range(300)]
        rows = run_both(events, DEEP[case], 64)
    finally:
        sys.setrecursionlimit(limit)
    assert rows
