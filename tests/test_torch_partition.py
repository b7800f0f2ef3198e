"""``partition with`` in the torch port, held to the JAX package.

* The cases of ``tests/test_partition.py`` that need neither the shard mesh
  nor a scan window run through both packages' ``compile_plan`` and
  ``Job`` (the port on the CPU) on the same seeded numpy columns: the
  per-key pattern (the slot NFA with the implicit ``el.key == e0.key``
  filter; K4's plain version here) against its oracle and the reference's
  rows, the partitioned aggregation, the per-key length window against its
  oracle, the per-key window that differs from the shared one, and the
  time-window oracle.
* Every refusal of the reference's ``_rewrite_partitioned`` and of its
  partitioned window dispatch gives the reference's own message; the
  partitioned ``unique``, ``sort`` and ``session`` windows, which the
  reference runs through its scan-window folds, name ROADMAP.md Queue 1
  item 8.
* ``PerKeyWindowArtifact`` stepped against the reference's on seeded
  tapes: several batches with a carried state, key growth past the first
  bucket, masked events, the reference's state loaded mid-stream; resident
  and fused rows equal to streaming rows; its segment body reads nothing
  on the host.
"""

from collections import defaultdict, deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_siddhi_tpu.compiler.config import EngineConfig as JaxConfig
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.sources import BatchSource as JaxSource
from flink_siddhi_tpu.runtime.tape import Tape as JaxTape
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.query.lexer import SiddhiQLError
from flink_siddhi_tpu_torch.runtime.tape import Tape as TorchTape

torch.set_num_threads(2)

PKGS = {
    "jax": (JaxSchema, JaxBatch, JaxSource, jax_compile, JaxJob, JaxConfig,
            {}),
    "torch": (fpt.StreamSchema, fpt.EventBatch, fpt.BatchSource,
              fpt.compile_plan, fpt.Job, fpt.EngineConfig,
              {"device": "cpu"}),
}

FIELDS = [("id", "int"), ("user", "int"), ("price", "double"),
          ("timestamp", "long")]
KVT = [("k", "int"), ("v", "double"), ("timestamp", "long")]

PAT_CQL = """
partition with (user of S)
begin
  from every s1 = S[id == 1] -> s2 = S[id == 2] -> s3 = S[id == 3]
  select s1.timestamp as t1, s3.timestamp as t3, s1.user as u
  insert into o;
end
"""


def make_data(seed=3, n=600, n_users=16):
    """tests/test_partition.py's stream: (id, user, price, timestamp)."""
    rng = np.random.default_rng(seed)
    return {"id": rng.integers(0, 5, n).astype(np.int32),
            "user": rng.integers(0, n_users, n).astype(np.int32),
            "price": rng.random(n),
            "timestamp": (1000 + np.arange(n)).astype(np.int64)}


def kvt(ks, vs, ts):
    return {"k": np.asarray(ks).astype(np.int32), "v": np.asarray(vs),
            "timestamp": np.asarray(ts, np.int64)}


def run(pkg, cql, fields, cols, batch, out="o", **cfg):
    """``cql`` over ``cols`` (stream S, micro-batches of ``batch``) through
    one package's Job: (rows, job)."""
    Schema, Batch, Source, compile_plan, Job, Config, kw = PKGS[pkg]
    schema = Schema(fields)
    ts = cols["timestamp"]
    batches = [Batch("S", schema, {k: v[s:s + batch] for k, v in cols.items()},
                     ts[s:s + batch])
               for s in range(0, len(ts), batch)]
    plan = compile_plan(cql, {"S": schema}, config=Config(**cfg))
    job = Job([plan], [Source("S", schema, iter(batches))],
              batch_size=batch, time_mode="processing", **kw)
    job.run()
    return job.results(out), job


def assert_same_rows(got, ref, oracle=None):
    """The port's rows against the reference's: same order, ints exact,
    floats within rtol 1e-5 — or, given the float64 ``oracle`` rows (the
    reference's time-window sums are differences of running float32
    sums), within rtol 1e-5 of the oracle or no further from it than
    twice the reference is."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert len(g) == len(r)
        for c, (a, b) in enumerate(zip(g, r)):
            if not isinstance(b, float):
                assert a == b
            elif a != pytest.approx(b, rel=1e-5, abs=1e-6):
                assert oracle is not None, (i, c, a, b)
                e = oracle[i][c]
                assert abs(a - e) <= max(2 * abs(b - e), 1e-5 * abs(e)), (
                    i, c, a, b, e)


def both(cql, fields, cols, batch, out="o", oracle=None, **cfg):
    """The port's rows, held to the reference's."""
    ref, _ = run("jax", cql, fields, cols, batch, out, **cfg)
    got, job = run("torch", cql, fields, cols, batch, out, **cfg)
    assert_same_rows(got, ref, oracle)
    return got, job


# -- tests/test_partition.py --------------------------------------------------

def oracle_per_key_chain(cols):
    out = []
    per_user = {}
    for eid, u, t in zip(cols["id"].tolist(), cols["user"].tolist(),
                         cols["timestamp"].tolist()):
        nxt = []
        for (t1, step) in per_user.get(u, []):
            if eid == step + 1:
                if step + 1 == 3:
                    out.append((t1, t, u))
                else:
                    nxt.append((t1, step + 1))
            else:
                nxt.append((t1, step))
        per_user[u] = nxt
        if eid == 1:
            per_user[u].append((t, 1))
    return sorted(out)


@pytest.mark.parametrize("batch", [64, 600])
def test_partitioned_pattern_matches_per_key_oracle(batch):
    cols = make_data()
    rows, job = both(PAT_CQL, FIELDS, cols, batch)
    assert sorted(rows) == oracle_per_key_chain(cols)
    (art,) = next(iter(job._plans.values())).plan.artifacts
    assert type(art).__name__ == "SlotNFAArtifact"


def test_partitioned_pattern_under_the_bench_settings():
    # the smoke's keyed pattern P1: a 512-slot pool, host predicates and
    # lazy projection; the per-key filter stays a cross-element program
    cols = make_data(seed=8, n=1500, n_users=40)
    cql = PAT_CQL.replace("select", "within 40 ms select")
    rows, _ = both(cql, FIELDS, cols, 512, pattern_slots=512,
                   lazy_projection=True, pred_pushdown=True)
    assert rows


def test_partitioned_aggregation_is_per_key():
    cols = make_data(n=200)
    rows, _ = both(
        "partition with (user of S) begin from S select user, sum(price) "
        "as total insert into totals; end", FIELDS, cols, 64, "totals")
    last = {u: total for u, total in rows}
    expect = defaultdict(float)
    for u, p in zip(cols["user"].tolist(), cols["price"].tolist()):
        expect[u] += p
    assert set(last) == set(expect)
    for u in expect:
        np.testing.assert_allclose(last[u], expect[u], rtol=1e-5)


@pytest.mark.parametrize("batch", [64, 500])
def test_partitioned_length_window_per_key_oracle(batch):
    rng = np.random.default_rng(21)
    n = 500
    ks = rng.integers(0, 7, n)
    vs = np.round(rng.random(n) * 10, 2)
    wins = defaultdict(lambda: deque(maxlen=3))
    oracle = []
    for ek, ev in zip(ks.tolist(), vs.astype(np.float32).tolist()):
        wins[ek].append(ev)
        oracle.append((ek, sum(wins[ek]), len(wins[ek])))
    rows, job = both(
        "partition with (k of S) begin from S#window.length(3) select k, "
        "sum(v) as s, count() as c insert into o end", KVT,
        kvt(ks, vs, 1000 + np.arange(n)), batch, oracle=oracle)
    (art,) = next(iter(job._plans.values())).plan.artifacts
    assert type(art).__name__ == "PerKeyWindowArtifact"
    assert len(rows) == n
    for (k, s, c), (ek, es, ec) in zip(rows, oracle):
        assert (k, c) == (ek, ec)
        assert s == pytest.approx(es, rel=1e-4)


def test_partitioned_window_differs_from_shared_window():
    cols = kvt([0, 1, 0, 1, 0, 1], [1.0, 10.0, 2.0, 20.0, 4.0, 40.0],
               np.arange(1000, 1006))
    part, _ = both("partition with (k of S) begin from S#window.length(2) "
                   "select k, sum(v) as s insert into o end", KVT, cols, 8)
    shared, _ = both("from S#window.length(2) select k, sum(v) as s "
                     "group by k insert into o", KVT, cols, 8)
    assert part[4][1] == pytest.approx(6.0)  # key 0's [2.0, 4.0]
    assert shared[4][1] == pytest.approx(4.0)  # the global last 2


def test_partitioned_time_window_oracle():
    rng = np.random.default_rng(5)
    n = 400
    ks = rng.integers(0, 5, n)
    vs = np.round(rng.random(n) * 10, 2)
    ts = 1000 + np.cumsum(rng.integers(1, 9, n)).astype(np.int64)
    oracle = []
    for i in range(n):
        member = [j for j in range(i + 1)
                  if ks[j] == ks[i] and ts[j] > ts[i] - 20]
        oracle.append((ks[i], sum(float(np.float32(vs[j])) for j in member),
                       len(member)))
    rows, _ = both("partition with (k of S) begin from S#window.time(20 ms) "
                   "select k, sum(v) as s, count() as c insert into o end",
                   KVT, kvt(ks, vs, ts), 64, oracle=oracle)
    assert len(rows) == n
    for (k, s, c), (ek, es, ec) in zip(rows, oracle):
        assert (k, c) == (ek, ec)
        assert s == pytest.approx(es, rel=1e-4)


def _compile(pkg, cql, fields=FIELDS):
    Schema, compile_plan = PKGS[pkg][0], PKGS[pkg][3]
    return compile_plan(cql, {"S": Schema(fields), "Other": Schema(fields)})


def test_partition_validation_errors():
    with pytest.raises(SiddhiQLError, match="no partition key"):
        _compile("torch", "partition with (user of Other) begin from every "
                 "s1 = S[id == 1] -> s2 = S[id == 2] select s1.timestamp "
                 "as t insert into o; end")
    with pytest.raises(SiddhiQLError, match="not supported yet"):
        _compile("torch", "partition with (user of S) begin from every "
                 "s1 = S[id == 1], s2 = S[id == 2] select s1.timestamp as t "
                 "insert into o; end")
    with pytest.raises(SiddhiQLError, match="partition"):
        _compile("torch", "partition with (user of S) begin from "
                 "S#window.timeBatch(10 ms) select user, sum(price) as t "
                 "insert into o; end")
    for w in ("#window.length(10)", "#window.time(10 ms)"):
        _compile("torch", f"partition with (user of S) begin from S{w} "
                 "select user, sum(price) as t insert into o; end")


def test_partitioned_non_every_rejected():
    with pytest.raises(SiddhiQLError, match="per partition key"):
        _compile("torch", "partition with (user of S) begin from s1 = "
                 "S[id == 1] -> s2 = S[id == 2] select s1.user as u insert "
                 "into o; end")


# every refusal of the reference's _rewrite_partitioned (plan.py:906-1030)
# and of its partitioned window dispatch (window.py:1911-1933, the per-key
# window's aggregates :2493-2498, scan_windows.py:344-351)
_P = "partition with ({key} of {sid}) begin {body}; end"
REFUSALS = {
    "join": ("user", "S", "from S#window.length(2) as a join "
             "S#window.length(2) as b on a.id == b.id select a.id as i "
             "insert into o"),
    "sequence": ("user", "S", "from every s1 = S[id == 1], s2 = S[id == 2] "
                 "select s1.timestamp as t insert into o"),
    "non_every": ("user", "S", "from s1 = S[id == 1] -> s2 = S[id == 2] "
                  "select s1.user as u insert into o"),
    "quantified_first": ("user", "S", "from every s1 = S[id == 1]<2:3> -> "
                         "s2 = S[id == 2] select s2.user as u insert into o"),
    "group_first": ("user", "S", "from every (s1 = S[id == 1] and s2 = "
                    "S[id == 2]) -> s3 = S[id == 3] select s3.user as u "
                    "insert into o"),
    "absent_element": ("user", "S", "from every s1 = S[id == 1] -> not "
                       "S[id == 2] for 1 sec select s1.user as u insert "
                       "into o"),
    "pattern_missing_key": ("user", "Other", "from every s1 = S[id == 1] -> "
                            "s2 = S[id == 2] select s1.timestamp as t "
                            "insert into o"),
    "pattern_key_not_an_attribute": ("nope", "S", "from every s1 = "
                                     "S[id == 1] -> s2 = S[id == 2] select "
                                     "s1.timestamp as t insert into o"),
    "stream_missing_key": ("user", "Other", "from S select user, "
                           "sum(price) as t insert into o"),
    "stream_key_not_an_attribute": ("nope", "S", "from S select price "
                                    "insert into o"),
    "expired_events": ("user", "S", "from S#window.length(3) select user, "
                       "sum(price) as t insert expired events into o"),
    "time_batch_window": ("user", "S", "from S#window.timeBatch(10 ms) "
                          "select user, sum(price) as t insert into o"),
    "length_batch_window": ("user", "S", "from S#window.lengthBatch(3) "
                            "select user, sum(price) as t insert into o"),
    "external_time_window": ("user", "S", "from S#window.externalTime("
                             "timestamp, 10 ms) select user, sum(price) "
                             "as t insert into o"),
    "frequent_window": ("user", "S", "from S#window.frequent(2) select "
                        "user, sum(price) as t insert into o"),
    "extra_group_by": ("user", "S", "from S#window.length(3) select user, "
                       "sum(price) as t group by id insert into o"),
    "min_over_a_per_key_window": ("user", "S", "from S#window.length(3) "
                                  "select user, min(price) as t insert "
                                  "into o"),
}


def _message(pkg, cql):
    try:
        plan = _compile(pkg, cql)
        if pkg == "jax":
            plan.init_state()  # the reference refuses min/max here
    except Exception as e:  # each package's own SiddhiQLError
        assert type(e).__name__ == "SiddhiQLError", e
        return str(e)
    return None


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_partition_refusals_carry_the_reference_text(case):
    key, sid, body = REFUSALS[case]
    cql = _P.format(key=key, sid=sid, body=body)
    ref = _message("jax", cql)
    assert ref is not None and _message("torch", cql) == ref


@pytest.mark.parametrize("window", ["unique(id)", "sort(4, price)",
                                    "session(10 ms)"])
def test_partitioned_scan_windows_name_their_item(window):
    # the partitioned sort and session came into the port (K9's [P, C]
    # buffers, K7 keyed by the partition); the unique window, whose
    # aggregates the reference masks to the arriving event's partition,
    # still names its item
    cql = _P.format(key="user", sid="S", body=f"from S#window.{window} "
                    "select user, sum(price) as s insert into o")
    _compile("jax", cql)  # the reference runs it through its scan folds
    came = {"sort(4, price)": "ScanWindowArtifact",
            "session(10 ms)": "SessionWindowArtifact"}
    if window in came:
        (art,) = _compile("torch", cql).artifacts
        assert type(art).__name__ == came[window]
        return
    with pytest.raises(SiddhiQLError, match="Queue 1 item 8"):
        _compile("torch", cql)


def test_partitioned_plain_window_drops_the_partition():
    # a windowed projection emits its arrivals unchanged: partitioning
    # changes nothing (the reference's rewrite drops it)
    cols = make_data(n=100)
    rows, job = both("partition with (user of S) begin from "
                     "S#window.length(3) select user, price insert into o; "
                     "end", FIELDS, cols, 32)
    assert len(rows) == 100
    (art,) = next(iter(job._plans.values())).plan.artifacts
    assert type(art).__name__ == "SelectArtifact"


# -- PerKeyWindowArtifact.step against the reference's --------------------------

PER_KEY = ("partition with (k of S) begin from S[v > 0.1]#window.length(5) "
           "select k, sum(v) as s, avg(v) as a, count() as c, stddev(v) as "
           "sd insert into o end")


def _step_tapes(rng, E, n_keys, code_key, encoders):
    """A tape of ``E`` positions, the last eighth invalid, keys in
    ``[0, n_keys)`` interned by each package's ``encoders``."""
    valid = np.arange(E) < E - E // 8
    ks = rng.integers(0, n_keys, E).astype(np.int32)
    vs = (rng.random(E) * 100).astype(np.float32)
    vs[rng.random(E) < 0.1] = 0.0  # filtered out
    cols = {"S.k": ks, "S.v": vs}
    ts = np.sort(rng.integers(0, 4 * E, E)).astype(np.int32)
    tapes = []
    for (Tape, arr), enc in zip(((JaxTape, jnp.asarray),
                                 (TorchTape, torch.from_numpy)), encoders):
        codes = enc.intern_rows([ks], valid & (vs > 0.1))
        c = dict(cols, **{code_key: codes})
        tapes.append(Tape(arr(ts), arr(np.where(valid, 0, -1)
                                       .astype(np.int32)),
                          arr(valid), {k: arr(v) for k, v in c.items()}))
    return tapes


def _close(ref, got, path=""):
    """States and outputs: ints and bools exact, floats within rtol 1e-5
    (a running sum's absolute error scales with its magnitude). A running
    sum ``S_*`` is compared with its compensation ``kc_*`` added, the sum
    it stands for."""
    if isinstance(ref, dict):
        for k, v in ref.items():
            if k.startswith("kc_"):
                continue
            if k.startswith("S_"):
                kc = "kc_" + k[2:]
                v, g = (np.asarray(v, np.float64) + np.asarray(ref[kc]),
                        got[k].double() + got[kc].double())
                np.testing.assert_allclose(g.numpy(), v, rtol=1e-5,
                                           atol=1e-3, err_msg=path + k)
                continue
            _close(v, got[k], f"{path}.{k}")
        return
    if isinstance(ref, tuple):
        for k, v in enumerate(ref):
            _close(v, got[k], f"{path}.{k}")
        return
    r, g = np.asarray(ref), got.numpy()
    assert r.shape == g.shape and r.dtype == g.dtype, path
    if r.dtype.kind == "f":
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-3, err_msg=path)
    else:
        assert np.array_equal(r, g), path


@pytest.mark.parametrize("load_at", [None, 2])
def test_per_key_window_step_matches_the_reference(load_at):
    jplan = jax_compile(PER_KEY, {"S": JaxSchema(KVT)})
    tplan = fpt.compile_plan(PER_KEY, {"S": fpt.StreamSchema(KVT)})
    (jart,), (tart,) = jplan.artifacts, tplan.artifacts
    assert type(tart).__name__ == "PerKeyWindowArtifact"
    assert tart.code_key == jart.code_key
    rng = np.random.default_rng(17)
    jst, tst = jplan.init_state(), tplan.init_state("cpu")
    # keys past the first bucket of 64 (and its doubling) as they arrive
    for b, (E, n_keys) in enumerate([(256, 40), (300, 90), (512, 150),
                                     (64, 150)]):
        jt, tt = _step_tapes(rng, E, n_keys, tart.code_key,
                             (jart.encoder, tart.encoder))
        jst, tst = jplan.grow_state(jst), tplan.grow_state(tst)
        if b == load_at:
            np_state = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                        for k, v in jst.items()}
            tst = fpt.state_from_numpy(
                tplan, np_state, "cpu",
                {e.out_key: e.encoder.state_dict()
                 for e in jplan.spec.encoded})
        jst, jout = jax.jit(jplan.step)(jst, jt)
        tst, tout = tplan.step(tst, tt)
        _close(jst, tst)  # the sumsq checkpoints and sums too
        # the outputs but the stddev, sqrt(m2 - mean^2) in float32: the
        # reference's jitted and eager steps differ there by 0.02
        (jm, jts, jcols), (tm, tts, tcols) = jout[jart.name], tout[tart.name]
        _close((jm, jts, jcols[:4]), (tm, tts, tcols[:4]))
        assert bool(tout[tart.name][0].any())
    assert tst[tart.name]["ring_sum0"].shape == (256, 5)


# -- the graph path's contracts on the CPU ---------------------------------------

PLANS = {
    "pattern": PAT_CQL,
    "per_key_window": ("partition with (user of S) begin from "
                       "S#window.length(8) select user, sum(price) as s, "
                       "count() as c insert into o; end"),
    "aggregation": ("partition with (user of S) begin from S select user, "
                    "sum(price) as o_ insert into o; end"),
}


def _job(cql, cols, batch, **kw):
    schema = fpt.StreamSchema(FIELDS)
    ts = cols["timestamp"]
    batches = [fpt.EventBatch("S", schema,
                              {k: v[s:s + batch] for k, v in cols.items()},
                              ts[s:s + batch])
               for s in range(0, len(ts), batch)]
    plan = fpt.compile_plan(cql, {"S": schema}, config=fpt.EngineConfig(
        lazy_projection=True, pred_pushdown=True))
    return fpt.Job([plan], [fpt.BatchSource("S", schema, iter(batches))],
                   batch_size=batch, time_mode="processing", device="cpu",
                   **kw)


@pytest.mark.parametrize("case", sorted(PLANS))
def test_resident_and_fused_rows_equal_streaming_rows(case):
    cols = make_data(seed=4, n=900, n_users=70)
    streaming = _job(PLANS[case], cols, 128)
    streaming.run()
    rows = streaming.results("o")
    assert rows
    resident = _job(PLANS[case], cols, 128)
    fpt.ResidentReplay(resident).execute()
    assert resident.results("o") == rows
    fused = _job(PLANS[case], cols, 128)
    fused.fused_segment_len = 4
    fused.run()
    assert fused.results("o") == rows
    assert fused.eager_segments == 0


def test_per_key_window_segment_body_makes_no_host_read():
    """The per-key window's step reads nothing on the host, what a CUDA
    graph could not capture: the segment body under the host-read guard
    of tests/test_torch_segments.py."""
    from test_torch_segments import HostReadGuard

    from flink_siddhi_tpu_torch.runtime.graphs import step_segment

    job = _job(PLANS["per_key_window"], make_data(seed=6, n=768,
                                                  n_users=90), 256,
               retain_results=False)
    rep = fpt.ResidentReplay(job)
    rep.stage()
    (rt,) = job._plans.values()
    (seg, *_), = rep.segments.values()
    tapes = seg.tapes()
    with HostReadGuard([[t.arrays() for t in tapes], rt.states, rt.acc]):
        states, acc = step_segment(rt.plan, rt.states, rt.acc, tapes)
    assert int(acc["meta"][0].sum()) == 768
    (art,) = rt.plan.artifacts
    assert int(states[art.name]["cnt"].sum()) == 768
