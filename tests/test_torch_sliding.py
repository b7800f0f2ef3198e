"""Sliding windows and cumulative aggregation in the torch port, against the
JAX package.

Each case runs one SiddhiQL query over the same seeded numpy stream in both
packages (the port on the CPU, ``tests/torch_windows_common.py``) and holds
the rows to the reference's: keys, timestamps, order, counts, integer sums
and min/max exactly; float32 sums, averages and deviations within rtol 1e-5,
or — where the reference's own float32 error is larger (the reference forms
a group's window sum as a difference of running float32 sums, and a
deviation from two such sums) — against a float64 numpy oracle, with the
port's largest error at most twice the reference's.

Covered: one case per artifact path — the sort path (``length`` and
event-time ``time`` windows, count/sum/avg/stddev, min/max over length
windows), the matrix path (min over a time window, ``externalTime``,
``timeLength``, ``distinctCount``), cumulative aggregation — each with
group-by, and with ``having`` and filters; an INT sum near +-2^31 that wraps
as int32 does; a running float sum where a naive float32 cumsum stalls; the
bench's ``window_groupby`` under its settings, with the raw group column
off the wire (and kept on it when ``having`` reads the group); a sliding
window's and a cumulative table's state and group encoder carried from
the JAX plan into the port mid-stream; and a time window over micro-batches
that arrive behind the stream, where the port follows the reference's
expiry rule (a numpy oracle) and the reference does not (ROADMAP.md
Queue 3).
"""

import jax
import numpy as np
import pytest
import torch

from flink_siddhi_tpu.compiler.config import EngineConfig as JaxConfig
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.tape import build_tape as jax_build_tape
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler.plan import state_to_numpy
from flink_siddhi_tpu_torch.compiler.window import (
    CumulativeAggArtifact,
    SlidingWindowArtifact,
)
from flink_siddhi_tpu_torch.runtime.tape import build_tape as torch_build_tape

from torch_windows_common import (
    assert_rows,
    batches,
    f32,
    flat,
    last,
    run,
    stats,
    stream,
    upto,
    window_oracle,
    within,
)

torch.set_num_threads(2)


def _all(f):
    return np.ones(len(f["id"]), bool)


# name -> (cql, (n_events, batch, n_ids), accept(f), path, oracle(f, acc)):
# ``oracle`` gives the float64 values of the float columns that may need
# one, ``path`` the artifact path the case must take
CASES = {
    "length_groupby": (
        "from S#window.length(100) select id, count() as c, "
        "sum(price) as s, avg(price) as a, stddev(price) as sd, "
        "min(price) as lo, max(vol) as hi group by id insert into out",
        (6000, 2048, 20), _all, "sort",
        lambda f, acc: {
            2: window_oracle(f, acc, last(100), stats(f, "price")[0]),
            3: window_oracle(f, acc, last(100), stats(f, "price")[1]),
            4: window_oracle(f, acc, last(100), stats(f, "price")[2]),
        },
    ),
    "length_filter_having": (
        "from S[price > 20.0]#window.length(64) select id, name, "
        "count() as c, sum(vol) as v, avg(price) as a group by id "
        "having c >= 3 insert into out",
        (5000, 1024, 12), lambda f: f["price"] > 20.0, "sort",
        lambda f, acc: {
            4: window_oracle(f, acc, last(64), stats(f, "price")[1])[
                window_oracle(f, acc, last(64), len) >= 3],
        },
    ),
    "length_no_group": (
        "from S#window.length(50) select min(price) as lo, "
        "max(price) as hi, sum(price) as s, avg(vol) as a "
        "insert into out",
        (5000, 2048, 20), _all, "sort",
        lambda f, acc: {
            2: window_oracle(f, acc, last(50), stats(f, "price")[0],
                             group=False),
        },
    ),
    "time_groupby": (
        "from S#window.time(300 milliseconds) select id, avg(price) as a, "
        "count() as c, sum(vol) as v group by id insert into out",
        (6000, 2048, 15), _all, "sort",
        lambda f, acc: {
            1: window_oracle(f, acc, within(f, 300), stats(f, "price")[1]),
        },
    ),
    "time_min_matrix": (
        "from S[vol > 0]#window.time(200 milliseconds) select "
        "min(price) as lo, max(vol) as hi, count() as c insert into out",
        (5000, 2048, 20), lambda f: f["vol"] > 0, "matrix", None,
    ),
    "external_time_groupby": (
        "from S#window.externalTime(timestamp, 250 milliseconds) "
        "select id, sum(price) as s, stddev(vol) as sd group by id "
        "insert into out",
        (5000, 2048, 10), _all, "matrix",
        lambda f, acc: {
            2: window_oracle(f, acc, within(f, 250, 512),
                             stats(f, "vol")[2]),
        },
    ),
    "time_length_having": (
        "from S#window.timeLength(200 milliseconds, 40) select id, "
        "sum(price) as s, count() as c group by id having c > 1 "
        "insert into out",
        (5000, 2048, 8), _all, "matrix", None,
    ),
    "distinct_count": (
        "from S#window.length(30) select id, distinctCount(name) as dc, "
        "count() as c group by id insert into out",
        (4000, 1024, 6), _all, "matrix", None,
    ),
    "cumulative_groupby": (
        "from S select id, count() as c, sum(price) as s, avg(vol) as a, "
        "stddev(price) as sd, min(price) as lo, max(vol) as hi, "
        "sum(vol) as v group by id insert into out",
        (6000, 2048, 20), _all, "cumulative",
        lambda f, acc: {
            4: window_oracle(f, acc, upto, stats(f, "price")[2]),
        },
    ),
    "cumulative_filter_having": (
        "from S[price > 30.0] select id, sum(vol) as s, "
        "stddev(price) as sd group by id having s > 0 insert into out",
        (6000, 2048, 20), lambda f: f["price"] > 30.0, "cumulative",
        lambda f, acc: {
            2: window_oracle(f, acc, upto, stats(f, "price")[2])[
                window_oracle(f, acc, upto,
                              lambda w: f["vol"][w].sum()) > 0],
        },
    ),
    "cumulative_no_group": (
        "from S select count() as c, sum(price) as s, max(price) as hi "
        "insert into out",
        (5000, 1024, 20), _all, "cumulative", None,
    ),
}


def _path(art) -> str:
    if isinstance(art, CumulativeAggArtifact):
        return "cumulative"
    assert isinstance(art, SlidingWindowArtifact)
    return "sort" if art._blocked() else "matrix"


@pytest.mark.parametrize("case", sorted(CASES))
def test_sliding_and_cumulative_rows_match_jax(case):
    cql, (n, batch, n_ids), accept, path, oracle = CASES[case]
    data = stream(n, batch, n_ids, seed=len(case))
    ref, _ = run("jax", cql, data, batch)
    got, tjob = run("torch", cql, data, batch)
    assert _path(tjob._plans["p"].plan.artifacts[0]) == path
    f = flat(data)
    assert_rows(got, ref, oracle(f, accept(f)) if oracle else None,
                min_rows=100)


def test_int_sum_wraps_as_int32_does():
    # vol near +-2^31: the window sums of an INT argument wrap modulo 2^32
    # exactly as the reference's (its digit planes; here int64, cut)
    def vol(rng, m):
        return rng.choice(np.array([2 ** 31 - 1, 2 ** 31 - 7, -2 ** 31,
                                    -2 ** 31 + 3, 5, -9], np.int64), m)

    cql = ("from S#window.length(8) select id, sum(vol) as v, "
           "avg(vol) as a, max(vol) as hi group by id insert into out")
    data = stream(3000, 1024, 3, seed=5, vol=vol)
    ref, _ = run("jax", cql, data, 1024)
    got, _ = run("torch", cql, data, 1024)
    assert got == ref
    f = flat(data)
    want = window_oracle(f, _all(f), last(8),
                         lambda w: f["vol"][w].astype(np.int64).sum())
    wrapped = ((want.astype(np.int64) + 2 ** 31) % 2 ** 32) - 2 ** 31
    assert [r[1] for _, r in got] == wrapped.tolist()
    assert np.abs(want).max() > 2 ** 31  # the sums did wrap


def test_running_sum_does_not_stall():
    # one huge price, then 4,000 small ones: a naive float32 running sum
    # stops moving (each addend is below half an ulp of 2^26), while the
    # compensated one tracks the float64 total in both packages
    cql = "from S select sum(price) as s insert into out"
    data = stream(4001, 1024, 1, seed=3)
    data[0]["price"][0] = float(2 ** 26)
    for d in data:
        d["price"][d["price"] != 2 ** 26] = 3.0
    ref, _ = run("jax", cql, data, 1024)
    got, _ = run("torch", cql, data, 1024)
    exact = np.cumsum(f32(flat(data)["price"]))
    naive = np.cumsum(flat(data)["price"].astype(np.float32),
                      dtype=np.float32)
    assert naive[-1] == 2 ** 26  # the naive sum stalled
    g = np.array([r[0] for _, r in got])
    e = np.array([r[0] for _, r in ref])
    # the running sums leave float32, so one ulp at 2^26 (8.0) of error
    # is the floor; the port's is at most twice the reference's
    port_err = np.abs(g - exact).max()
    assert port_err <= min(8.0, 2 * np.abs(e - exact).max())
    assert np.abs(naive - exact).max() > 1000 * port_err


WINDOW_GROUPBY = (
    "from S#window.length(1000) select id, sum(price) as total, "
    "count() as cnt group by id insert into out"
)
BENCH = dict(lazy_projection=True, pred_pushdown=True)


@pytest.mark.parametrize("resident", [False, True],
                         ids=["streaming", "resident"])
def test_window_groupby_under_bench_settings(resident):
    """The bench's window_groupby (1,000 ids) as bench.py configures it:
    the group column travels as its code only, and the rows decode the
    ids back through the encoder, as columns too."""
    data = stream(4 * 8192, 8192, 1000, seed=1)
    ref, jjob = run("jax", WINDOW_GROUPBY, data, 8192, resident=resident,
                    **BENCH)
    got, tjob = run("torch", WINDOW_GROUPBY, data, 8192,
                    resident=resident, **BENCH)
    f = flat(data)
    assert_rows(got, ref, {1: window_oracle(f, _all(f), last(1000),
                                            stats(f, "price")[0])},
                min_rows=4 * 8192)
    plan = tjob._plans["p"].plan
    assert plan.spec.device_columns == ("S.price",)
    assert plan.artifacts[0].group_code_proj == (0, None, None)
    # the columnar decode of one block equals the reference's
    arts = (jjob._plans["p"].plan.artifacts[0], plan.artifacts[0])
    n = 300
    block = np.stack([np.arange(n), np.arange(n) % 900,
                      np.float32(np.arange(n)).view(np.int32),
                      np.arange(n) % 7]).astype(np.int32)
    (_, jcols), = arts[0].decode_packed_columns(n, block)
    (_, tcols), = arts[1].decode_packed_columns(n, block)
    assert np.array_equal(tcols.ts, jcols.ts)
    for k in jcols.cols:
        assert list(tcols.cols[k]) == list(jcols.cols[k]), k


def test_window_state_and_encoder_carried_from_jax_into_port():
    """The JAX plan steps batch 1 of a grouped length window; its ring,
    group table and encoder, fetched to the host, seed the port's plan;
    both step batch 2 from there."""
    cql = ("from S#window.length(500) select id, sum(price) as s, "
           "count() as c, max(vol) as hi group by id insert into out")
    data = stream(2 * 2048, 2048, 150, seed=21)
    (js, jb), (ts, tb) = batches("jax", data), batches("torch", data)
    jplan = jax_compile(cql, {"S": js})
    tplan = fpt.compile_plan(cql, {"S": ts})
    epoch = 1000
    jstep = jax.jit(jplan.step_acc)
    jt1, _ = jax_build_tape(jplan.spec, [jb[0]], epoch)
    jst, _ = jstep(jplan.grow_state(jplan.init_state()), jplan.init_acc(),
                   jt1)
    carried = jax.device_get(jst)
    encoders = {e.out_key: e.encoder.state_dict() for e in jplan.spec.encoded}
    assert sorted(carried["query_0"]) == ["enabled", "groups", "ring"]
    assert carried["query_0"]["ring"]["valid"].all()

    tst = fpt.state_from_numpy(tplan, carried, "cpu", encoders=encoders)
    jt2, _ = jax_build_tape(jplan.spec, [jb[1]], epoch)
    tt2 = torch_build_tape(tplan.spec, [tb[1]], epoch).to(torch.device("cpu"))
    jst2, jacc = jstep(jplan.grow_state(jst), jplan.init_acc(), jt2)
    tst2, tacc = tplan.step_acc(tplan.grow_state(tst), tplan.init_acc("cpu"),
                                tt2)

    def rows(plan, meta, buf):
        counts = np.asarray(meta)[0]
        return plan.drain_decode(counts, np.asarray(buf)[:, :counts.max()])

    jrows = rows(jplan, jacc["meta"], jacc["buf"])["query_0"][0][1]
    trows = rows(tplan, tacc["meta"].numpy(), tacc["buf"].numpy())[
        "query_0"][0][1]
    assert_rows(trows, jrows, min_rows=2048)
    # batch 2's first windows hold batch 1's events
    assert jrows[0][1][2] > 1
    jfinal = jax.device_get(jst2)["query_0"]["ring"]
    tfinal = state_to_numpy(tst2)["query_0"]["ring"]
    assert sorted(jfinal) == sorted(tfinal)
    for k in jfinal:
        assert np.array_equal(np.asarray(jfinal[k]), tfinal[k]), k


def test_cumulative_state_carried_from_jax_into_port():
    cql = ("from S select id, sum(price) as s, min(vol) as lo, "
           "count() as c group by id insert into out")
    data = stream(2 * 1024, 1024, 90, seed=4)
    (js, jb), (ts, tb) = batches("jax", data), batches("torch", data)
    jplan = jax_compile(cql, {"S": js})
    tplan = fpt.compile_plan(cql, {"S": ts})
    jstep = jax.jit(jplan.step_acc)
    jt1, _ = jax_build_tape(jplan.spec, [jb[0]], 1000)
    jst, _ = jstep(jplan.grow_state(jplan.init_state()), jplan.init_acc(),
                   jt1)
    encoders = {e.out_key: e.encoder.state_dict() for e in jplan.spec.encoded}
    carried = jax.device_get(jst)
    tst = fpt.state_from_numpy(tplan, carried, "cpu", encoders=encoders)
    assert sorted(tst["query_0"]) == sorted(carried["query_0"]) == [
        "cnt", "enabled", "kc_sum0", "min1", "sum0"]
    jt2, _ = jax_build_tape(jplan.spec, [jb[1]], 1000)
    tt2 = torch_build_tape(tplan.spec, [tb[1]], 1000).to(torch.device("cpu"))
    _, jacc = jstep(jplan.grow_state(jst), jplan.init_acc(), jt2)
    _, tacc = tplan.step_acc(tplan.grow_state(tst), tplan.init_acc("cpu"),
                             tt2)
    jc, tc = np.asarray(jacc["meta"])[0], tacc["meta"].numpy()[0]
    jrows = jplan.drain_decode(jc, np.asarray(jacc["buf"])[:, :jc.max()])
    trows = tplan.drain_decode(tc, tacc["buf"].numpy()[:, :tc.max()])
    assert_rows(trows["query_0"][0][1], jrows["query_0"][0][1],
                min_rows=1024)
    # the counts carried on from batch 1
    assert trows["query_0"][0][1][-1][1][3] > 20


def test_sliding_window_wire_keeps_raw_column_when_having():
    # having may read a coded alias: the wire option stands down, as in
    # the reference, and the raw group column ships
    cql = ("from S#window.length(10) select id, count() as c group by id "
           "having c > 1 insert into out")
    schema = fpt.StreamSchema([("id", "int"), ("price", "double")])
    plan = fpt.compile_plan(cql, {"S": schema},
                            config=fpt.EngineConfig(**BENCH))
    assert plan.spec.device_columns is None
    jplan = jax_compile(cql, {"S": JaxSchema([("id", "int"),
                                              ("price", "double")])},
                        config=JaxConfig(**BENCH))
    assert jplan.spec.device_columns is None


def _straggler_oracle(data, span, capacity, group):
    """(ts, sum, count) per event of a grouped ``#window.time(span)`` on
    the sort path, by the reference's own expiry rule: per micro-batch,
    the sequence is the ring (the last ``capacity`` entries) followed by
    the batch's events; entry p leaves the window at exp_rank[p], the
    first position whose running-maximum timestamp reaches ts[p] + span
    and never before p + 1; the window of arrival q holds the live
    entries p <= q with exp_rank[p] > q (float64 sums)."""
    C = capacity
    ring = dict(ts=np.zeros(C, np.int64), live=np.zeros(C, bool),
                v=np.zeros(C), id=np.zeros(C, np.int64))
    out = []
    for b in data:
        M = len(b["ts"])
        ts = np.concatenate([ring["ts"], b["ts"] - 1000])
        live = np.concatenate([ring["live"], np.ones(M, bool)])
        v = np.concatenate([ring["v"], f32(b["price"])])
        ids = np.concatenate([ring["id"], b["id"]])
        pos = np.arange(C + M)
        mono = np.maximum.accumulate(ts)
        exp_rank = np.maximum(np.searchsorted(mono, ts + span), pos + 1)
        for k in range(M):
            q = C + k
            m = live[:q + 1] & (exp_rank[:q + 1] > q)
            if group:
                m &= ids[:q + 1] == ids[q]
            out.append((int(b["ts"][k]), v[:q + 1][m].sum(), int(m.sum())))
        ring = dict(ts=ts[M:M + C], live=live[M:M + C], v=v[M:M + C],
                    id=ids[M:M + C])
    return sorted(out, key=lambda r: r[0])


@pytest.mark.parametrize("group", [True, False], ids=["groupby", "no_group"])
def test_time_window_stragglers_follow_the_expiry_rule(group):
    """Two micro-batches arrive 400 ms behind the stream (processing
    time): their events leave a 300 ms window before older entries do.
    The port's rows follow the reference's expiry rule (the oracle); the
    reference's own rows do not, because its merge of arrivals and
    expiries assumes expiries in sequence order (ROADMAP.md Queue 3)."""
    data = stream(4096, 1024, 5, seed=8)
    for i in (1, 3):
        data[i]["ts"] = data[i]["ts"] - 400
    cql = ("from S#window.time(300 milliseconds) select "
           + ("id, " if group else "")
           + "sum(price) as s, count() as c "
           + ("group by id " if group else "") + "insert into out")
    ref, _ = run("jax", cql, data, 1024)
    got, _ = run("torch", cql, data, 1024)
    want = _straggler_oracle(data, 300, 512, group)
    assert [t for t, _ in got] == [w[0] for w in want] == [t for t, _ in ref]
    assert [r[-1] for _, r in got] == [c for _, _, c in want]
    assert np.allclose([r[-2] for _, r in got], [s for _, s, _ in want],
                       rtol=1e-6)
    # the reference's counts leave the rule on many rows
    assert sum(r[-1] != c for (_, r), (_, _, c) in zip(ref, want)) > 500
