"""``#window.unique`` aggregation in the torch port, against the JAX package.

Each test makes a quote stream with numpy from a seed — Siddhi's standard
``StockStream (symbol string, price double, volume long)``, symbols drawn
with Zipf rank weights, price uniform in [1, 500) to the cent, volume an
integer in [1, 10,000] — hands the same columns to both packages, runs the
same SiddhiQL through ``compile_plan`` -> ``Job`` on each side (the port on
the CPU, through the plain version of its unique-fold kernel; the JAX
package through its ``lax.scan`` fold, as tests/conftest.py pins it on the
CPU), and compares the rows one by one: the same timestamps, keys, counts,
minima and maxima exactly, and sums and averages within ``np.allclose``'s
defaults (rtol 1e-5), the tolerance of the JAX package's own fold probe —
the two packages add the slot values of a float32 sum in different orders.

Covered: the quote board, a table that grows past its first 128-slot
bucket across micro-batches, a filtered stream (host interning through the
query's filter closures), ``count()`` alone (no value column), engine state
and group-key encoder carried from the JAX plan into the port mid-stream,
and the shapes that stay with later slices, which raise ``SiddhiQLError``
naming the torch port (while the JAX package compiles them).
"""

import jax
import numpy as np
import pytest
import torch

from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.sources import BatchSource as JaxSource
from flink_siddhi_tpu.runtime.tape import build_tape as jax_build_tape
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler.plan import state_to_numpy
from flink_siddhi_tpu_torch.query.lexer import SiddhiQLError
from flink_siddhi_tpu_torch.runtime.tape import build_tape as torch_build_tape

torch.set_num_threads(2)

_FIELDS = [("symbol", "string"), ("price", "double"), ("volume", "long")]

QUOTE_BOARD = (
    "from StockStream#window.unique(symbol) "
    "select symbol, count() as symbols, sum(price * volume) as notional, "
    "avg(price) as avg_price, min(price) as lo, max(price) as hi "
    "insert into Board"
)
# columns of QUOTE_BOARD compared exactly / within np.allclose
_EXACT, _CLOSE = (0, 1, 4, 5), (2, 3)

_PKGS = {
    "jax": (JaxSchema, JaxBatch, JaxSource, jax_compile, JaxJob, {}),
    "torch": (fpt.StreamSchema, fpt.EventBatch, fpt.BatchSource,
              fpt.compile_plan, fpt.Job, {"device": "cpu"}),
}


def _quotes(n_events, n_symbols, seed):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_symbols + 1)
    return {
        "symbol": rng.choice(n_symbols, size=n_events, p=w / w.sum()),
        "price": np.round(rng.uniform(1.0, 500.0, n_events), 2),
        "volume": rng.integers(1, 10_001, n_events),
        "ts": 1000 + np.arange(n_events, dtype=np.int64),
    }


def _batches(Schema, Batch, data, batch, n_symbols):
    schema = Schema(_FIELDS)
    table = schema.string_tables["symbol"]
    codes = np.array([table.intern(f"S{i:05d}") for i in range(n_symbols)],
                     np.int32)
    out = []
    for s in range(0, len(data["ts"]), batch):
        sl = slice(s, s + batch)
        out.append(Batch(
            "StockStream", schema,
            {"symbol": codes[data["symbol"][sl]],
             "price": data["price"][sl], "volume": data["volume"][sl]},
            data["ts"][sl],
        ))
    return schema, out


def _run(pkg, cql, data, batch, n_symbols):
    Schema, Batch, Source, compile_plan, Job, kw = _PKGS[pkg]
    schema, batches = _batches(Schema, Batch, data, batch, n_symbols)
    plan = compile_plan(cql, {"StockStream": schema}, plan_id="p")
    job = Job([plan], [Source("StockStream", schema, iter(batches))],
              batch_size=batch, time_mode="processing", **kw)
    job.run()
    return job.results_with_ts("Board"), job


def _assert_rows_match(got, ref, exact, close):
    assert len(got) == len(ref) > 0
    assert [t for t, _ in got] == [t for t, _ in ref]
    for i in exact:
        assert [r[i] for _, r in got] == [r[i] for _, r in ref], i
    for i in close:
        assert np.allclose([r[i] for _, r in got], [r[i] for _, r in ref]), i


def _assert_same(cql, data, batch, n_symbols, exact, close):
    ref, jjob = _run("jax", cql, data, batch, n_symbols)
    got, tjob = _run("torch", cql, data, batch, n_symbols)
    _assert_rows_match(got, ref, exact, close)
    return ref, jjob, tjob


@pytest.mark.parametrize("n_symbols,batch", [(100, 1024), (1000, 2048)])
def test_quote_board_matches_jax(n_symbols, batch):
    data = _quotes(4000, n_symbols, seed=n_symbols)
    ref, _, tjob = _assert_same(QUOTE_BOARD, data, batch, n_symbols,
                                _EXACT, _CLOSE)
    # every event emits one row; the count climbs to the distinct keys
    assert len(ref) == 4000
    assert ref[-1][1][1] == len(np.unique(data["symbol"]))
    state = tjob._plans["p"].states["query_0"]
    assert sorted(state) == ["a0", "a1", "enabled", "valid"]
    assert int(state["valid"].sum()) == ref[-1][1][1]


def test_quote_board_non_finite_prices_match_jax():
    # NaN, +inf and -inf prices over few symbols, so that later quotes
    # overwrite them: a NaN lasts only while its slot holds it, and an inf
    # with a -inf valid at once gives a NaN sum
    data = _quotes(4000, 40, seed=17)
    r = np.random.default_rng(17).random(4000)
    data["price"][r < 0.004] = np.nan
    data["price"][(r >= 0.004) & (r < 0.008)] = np.inf
    data["price"][(r >= 0.008) & (r < 0.012)] = -np.inf
    ref, _ = _run("jax", QUOTE_BOARD, data, 1024, 40)
    got, _ = _run("torch", QUOTE_BOARD, data, 1024, 40)
    assert len(got) == len(ref) == 4000
    assert [t for t, _ in got] == [t for t, _ in ref]
    for i in range(6):
        g = np.array([row[i] for _, row in got])
        e = np.array([row[i] for _, row in ref])
        if i == 0:
            assert list(g) == list(e)
            continue
        g, e = g.astype(np.float64), e.astype(np.float64)
        assert np.array_equal(np.isnan(g), np.isnan(e)), i
        if i in _EXACT:
            assert np.array_equal(g, e, equal_nan=True), i
        else:
            assert np.allclose(g, e, rtol=1e-5, equal_nan=True), i
        if i > 1:  # each value column shows non-finite rows, and loses them
            bad = ~np.isfinite(e)
            assert bad.any() and not bad[np.argmax(bad):].all(), i


def test_table_grows_past_first_bucket_across_batches():
    # ~300 keys arrive over batches of 64: the table re-buckets 128 -> 256
    # -> 512 between micro-batches, carrying every slot across
    data = _quotes(1600, 500, seed=11)
    ref, _, tjob = _assert_same(QUOTE_BOARD, data, 64, 500, _EXACT, _CLOSE)
    seen, expect = set(), []
    for k in data["symbol"]:
        seen.add(k)
        expect.append(len(seen))
    assert [r[1] for _, r in ref] == expect
    assert expect[-1] > 256
    assert tuple(tjob._plans["p"].states["query_0"]["valid"].shape) == (512,)


def test_filtered_stream_interns_only_accepted_keys():
    cql = (
        "from StockStream[price > 100]#window.unique(symbol) "
        "select symbol, count() as symbols, max(price) as hi, "
        "sum(volume * 1.0) as shares insert into Board"
    )
    data = _quotes(3000, 400, seed=5)
    ref, _, tjob = _assert_same(cql, data, 512, 400, (0, 1, 2), (3,))
    accepted = data["price"] > 100
    assert len(ref) == int(accepted.sum())
    # the encoder holds only keys of accepted events
    enc = tjob._plans["p"].plan.spec.encoded[0].encoder
    assert len(enc) == len(np.unique(data["symbol"][accepted]))


def test_count_only_has_no_value_column():
    cql = (
        "from StockStream#window.unique(symbol) "
        "select count() as symbols insert into Board"
    )
    data = _quotes(2500, 700, seed=3)
    _, _, tjob = _assert_same(cql, data, 1000, 700, (0,), ())
    assert sorted(tjob._plans["p"].states["query_0"]) == ["enabled", "valid"]


def test_state_and_encoder_carried_from_jax_into_port():
    """The JAX plan folds batch 1; its state and its group-key encoder,
    fetched to the host, seed the port's plan; both fold batch 2 from the
    same table."""
    n_symbols = 500
    data = _quotes(2 * 2048, n_symbols, seed=21)
    jschema, jb = _batches(JaxSchema, JaxBatch, data, 2048, n_symbols)
    tschema, tb = _batches(fpt.StreamSchema, fpt.EventBatch, data, 2048,
                           n_symbols)
    jplan = jax_compile(QUOTE_BOARD, {"StockStream": jschema})
    tplan = fpt.compile_plan(QUOTE_BOARD, {"StockStream": tschema})
    epoch = 1000
    jstep = jax.jit(jplan.step_acc)
    jt1, _ = jax_build_tape(jplan.spec, [jb[0]], epoch)
    jst, _ = jstep(jplan.grow_state(jplan.init_state()), jplan.init_acc(),
                   jt1)
    carried = jax.device_get(jst)
    encoders = {e.out_key: e.encoder.state_dict() for e in jplan.spec.encoded}
    assert carried["query_0"]["valid"].sum() > 128

    tst = fpt.state_from_numpy(tplan, carried, "cpu", encoders=encoders)
    jt2, _ = jax_build_tape(jplan.spec, [jb[1]], epoch)
    tt2 = torch_build_tape(tplan.spec, [tb[1]], epoch).to(torch.device("cpu"))
    jst2, jacc = jstep(jplan.grow_state(jst), jplan.init_acc(), jt2)
    tst2, tacc = tplan.step_acc(tplan.grow_state(tst), tplan.init_acc("cpu"),
                                tt2)

    def rows(plan, meta, buf):
        counts = np.asarray(meta)[0]
        n = int(counts.max())
        return plan.drain_decode(counts, np.asarray(buf)[:, :n])["query_0"]

    jrows = rows(jplan, jacc["meta"], jacc["buf"])[0][1]
    trows = rows(tplan, tacc["meta"].numpy(), tacc["buf"].numpy())[0][1]
    _assert_rows_match(trows, jrows, _EXACT, _CLOSE)
    # batch 2 starts from the carried keys, not from an empty table
    assert jrows[0][1][1] > 128
    jfinal = jax.device_get(jst2)["query_0"]
    tfinal = state_to_numpy(tst2)["query_0"]
    assert sorted(jfinal) == sorted(tfinal)
    for k in jfinal:
        assert np.array_equal(np.asarray(jfinal[k]), tfinal[k]), k


def test_state_from_numpy_needs_the_encoders():
    tplan = fpt.compile_plan(QUOTE_BOARD,
                             {"StockStream": fpt.StreamSchema(_FIELDS)})
    st = state_to_numpy(tplan.init_state("cpu"))
    with pytest.raises(KeyError, match="encoder"):
        fpt.state_from_numpy(tplan, st, "cpu")
    # a table that does not match the loaded encoder's bucket is refused
    encoders = {tplan.spec.encoded[0].out_key:
                {"values": [(i,) for i in range(200)]}}
    with pytest.raises(ValueError, match="valid"):
        fpt.state_from_numpy(tplan, st, "cpu", encoders=encoders)


_LATER = {
    "sort_with_aggregates": (
        "from StockStream#window.sort(8, price) "
        "select sum(price) as s insert into Board"
    ),
    "session": (
        "from StockStream#window.session(10 ms, symbol) "
        "select symbol, count() as c insert into Board"
    ),
    "frequent": (
        "from StockStream#window.frequent(2, symbol) "
        "select symbol, count() as c insert into Board"
    ),
    "partitioned_unique": (
        "partition with (symbol of StockStream) begin "
        "from StockStream#window.unique(symbol) "
        "select count() as c insert into Board; end"
    ),
    "int_value_column": (
        "from StockStream#window.unique(symbol) "
        "select sum(volume) as v, max(volume) as m insert into Board"
    ),
    "partitioned_length_window": (
        "partition with (symbol of StockStream) begin "
        "from StockStream#window.length(16) "
        "select symbol, sum(price) as s insert into Board; end"
    ),
    "output_rate_limit": (
        "from StockStream#window.length(16) select sum(price) as s "
        "output last every 5 events insert into Board"
    ),
    "more_aggregates_than_the_fold_plan": (
        "from StockStream#window.unique(symbol) select "
        + ", ".join(f"sum(price + {k}) as s{k}" for k in range(65))
        + " insert into Board"
    ),
}


# forms of _LATER that a later slice brought into the port: each compiles
# to its artifact (the case keeps its id)
_CAME = {"partitioned_length_window": "PerKeyWindowArtifact",
         "sort_with_aggregates": "ScanWindowArtifact",
         "session": "SessionWindowArtifact",
         "frequent": "FrequencyWindowArtifact",
         "int_value_column": "ScanWindowArtifact",
         "more_aggregates_than_the_fold_plan": "ScanWindowArtifact"}


@pytest.mark.parametrize("name", sorted(_LATER))
def test_later_slices_raise_naming_the_port(name):
    cql = _LATER[name]
    # the reference compiles it; the port names its later slice
    jax_compile(cql, {"StockStream": JaxSchema(_FIELDS)})
    if name in _CAME:
        plan = fpt.compile_plan(
            cql, {"StockStream": fpt.StreamSchema(_FIELDS)})
        assert [type(a).__name__ for a in plan.artifacts] == [_CAME[name]]
        return
    with pytest.raises(SiddhiQLError, match="torch port"):
        fpt.compile_plan(cql, {"StockStream": fpt.StreamSchema(_FIELDS)})
