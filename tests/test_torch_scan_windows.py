"""The scan windows in the torch port, against the JAX package.

``#window.session`` (K7, ``cuda_ops.session_scan``), ``#window.frequent``
and ``lossyFrequent`` (K8, ``frequency_scan``), ``#window.sort`` with
aggregates (K9, ``sort_window_scan``), and ``#window.unique`` over INT/LONG
value columns and with more than 64 aggregates (K3's integer path and its
groups of slots). On the CPU each kernel wrapper runs its plain PyTorch
version; the JAX package runs its ``lax.scan`` bodies.

The streams are ``tests/torch_windows_common.py``'s (numpy from a seed:
id, name, price in [0, 100), vol, timestamp 1 ms apart), three micro-batches
with the state carried. Tolerances: counts, timestamps, keys, emission,
membership, minima and maxima exactly (NaN where the reference has NaN);
float sums and averages within rtol 1e-5 (the kernels add a table's values
in another order than XLA's sum; K7's per-key sums add in the reference's
own order and are compared bit for bit in the state); an INT/LONG sum
(a float32 sum cast to int, as the reference computes it) within rtol 1e-5
too, since the float32 sum's rounding moves it by ulps.
"""

import jax
import numpy as np
import pytest
import torch
from torch_windows_common import batches, job, run, stream

from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.tape import build_tape as jax_build_tape

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler import cuda_ops, scan_windows
from flink_siddhi_tpu_torch.compiler.plan import state_to_numpy
from flink_siddhi_tpu_torch.runtime.tape import build_tape as torch_build_tape

torch.set_num_threads(2)

RTOL = 1e-5
BIG_VOL = (lambda rng, m: rng.integers(0, 2 ** 31 - 1, m))  # past 2^24


def _nan_price(every):
    def data(d):
        for b in d:
            b["price"][::every] = np.nan
        return d
    return data


def _late(d):
    # stragglers: 2% of events arrive up to 60 ms late (ts below the
    # keys' session clocks)
    rng = np.random.default_rng(99)
    for b in d:
        late = rng.random(len(b["ts"])) < 0.02
        b["ts"] = b["ts"] - np.where(late, rng.integers(1, 60, len(late)), 0)
    return d


# name -> (cql, n_ids, vol override, data hook, int-sum columns)
CASES = {
    "session_keyed": (
        "from S#window.session(25 ms, id) select id, count() as c, "
        "sum(price) as s, min(vol) as lo, max(price) as hi, avg(vol) as a "
        "insert into out", 20, None, None, ()),
    "session_unkeyed_filtered": (
        "from S[price > 90.0]#window.session(8 ms) select count() as c, "
        "sum(price) as s, max(vol) as m insert into out", 20, None, None,
        ()),
    "session_partitioned": (
        "partition with (id of S) begin from S#window.session(30 ms) "
        "select id, sum(price) as s, count() as c insert into out; end",
        20, None, None, ()),
    "session_stragglers": (
        "from S#window.session(20 ms, id) select id, count() as c, "
        "min(price) as lo, max(vol) as hi insert into out", 16, None, _late,
        ()),
    "session_int_past_2_24": (
        "from S#window.session(25 ms, name) select name, min(vol) as lo, "
        "max(vol) as hi, sum(vol) as s insert into out", 20, BIG_VOL, None,
        (3,)),
    "sort_asc": (
        "from S#window.sort(5, price) select count() as c, sum(price) as s,"
        " min(vol) as lo, max(vol) as hi, avg(price) as a insert into out",
        20, None, None, ()),
    "sort_desc": (
        "from S#window.sort(4, price, 'desc') select id, max(price) as hi, "
        "min(price) as lo, count() as c insert into out", 20, None, None,
        ()),
    "sort_partitioned": (
        "partition with (id of S) begin from S#window.sort(3, price) "
        "select id, min(price) as mn, sum(vol) as v, count() as c "
        "insert into out; end", 20, None, None, (2,)),
    "sort_nan_key": (
        "from S#window.sort(6, price) select count() as c, min(price) as lo,"
        " max(price) as hi, sum(price) as s insert into out", 20, None,
        _nan_price(7), ()),
    "sort_int_args": (
        "from S#window.sort(8, price, 'desc') select min(vol) as lo, "
        "max(vol) as hi, sum(vol) as s, avg(vol) as a insert into out", 20,
        BIG_VOL, None, (2,)),
    "frequent": (
        "from S#window.frequent(3, id) select id, count() as c, "
        "sum(price) as s, max(vol) as m insert into out", 20, None, None,
        ()),
    "frequent_all_attributes": (
        "from S#window.frequent(4) select id, count() as c, min(price) as lo"
        " insert into out", 5, None, None, ()),
    "lossy": (
        "from S#window.lossyFrequent(0.1, 0.02, id) select id, count() as c,"
        " sum(price) as s insert into out", 20, None, None, ()),
    "lossy_default_error": (
        "from S#window.lossyFrequent(0.15, id) select id, count() as c, "
        "max(vol) as m insert into out", 6, None, None, ()),
    "unique_int": (
        "from S#window.unique(id) select sum(vol) as v, max(vol) as m, "
        "min(vol) as lo, avg(vol) as a insert into out", 40, BIG_VOL, None,
        (0,)),
    "unique_mixed": (
        "from S#window.unique(id) select id, sum(vol) as v, avg(price) as p,"
        " min(price) as lo, max(vol) as hi insert into out", 300, None, None,
        (1,)),
    "unique_65_aggregates": (
        "from S#window.unique(id) select " + ", ".join(
            f"sum(price + {k}) as s{k}" for k in range(64))
        + ", max(vol) as m insert into out", 40, None, None, ()),
}


def _data(case, n=1536, batch=512):
    _, n_ids, vol, hook, _ = CASES[case]
    d = stream(n, batch, n_ids, seed=len(case), vol=vol)
    return hook(d) if hook else d


def assert_rows_close(got, ref, int_close=()):
    """Rows of the port against the reference's (module docstring)."""
    assert len(got) == len(ref)
    assert [t for t, _ in got] == [t for t, _ in ref]
    for c in range(len(ref[0][1]) if ref else 0):
        g = [r[c] for _, r in got]
        e = [r[c] for _, r in ref]
        if c in int_close:
            assert np.allclose(g, e, rtol=RTOL, atol=0), c
        elif any(isinstance(v, float) for v in e):
            g, e = np.asarray(g, np.float64), np.asarray(e, np.float64)
            assert np.array_equal(np.isnan(g), np.isnan(e)), c
            assert np.allclose(g, e, rtol=RTOL, atol=0, equal_nan=True), c
        else:
            assert g == e, c


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_match_the_reference(case):
    cql, *_, int_close = CASES[case]
    data = _data(case)
    ref, _ = run("jax", cql, data, 512)
    got, tjob = run("torch", cql, data, 512)
    assert len(ref) >= 3
    assert_rows_close(got, ref, int_close)
    kind = {"session": "SessionWindowArtifact", "sort": "ScanWindowArtifact",
            "unique": "ScanWindowArtifact", "frequent":
            "FrequencyWindowArtifact", "lossy": "FrequencyWindowArtifact"}
    (art,) = tjob._plans["p"].plan.artifacts
    assert type(art).__name__ == kind[case.split("_")[0]]


def test_the_65_aggregates_take_two_fold_calls(monkeypatch):
    calls = []
    real = scan_windows.unique_window_fold

    def count(*args):
        calls.append(len(args[5]))
        return real(*args)

    monkeypatch.setattr(scan_windows, "unique_window_fold", count)
    run("torch", CASES["unique_65_aggregates"][0],
        _data("unique_65_aggregates"), 512)
    assert calls == [64, 1] * 3


# -- the reference's own oracles (tests/test_window_zoo.py and
# tests/test_partition.py), run against the port ---------------------------

ZOO = fpt.StreamSchema([("id", "int"), ("price", "double"),
                        ("timestamp", "long")])
KVT = fpt.StreamSchema([("k", "int"), ("v", "double"), ("timestamp", "long")])


def _zoo_run(cql, cols, batch=8, schema=ZOO):
    n = len(cols["timestamp"])
    bs = [fpt.EventBatch("S", schema, {k: np.asarray(v[s:s + batch])
                                        for k, v in cols.items()},
                         np.asarray(cols["timestamp"][s:s + batch],
                                    np.int64))
          for s in range(0, n, batch)]
    plan = fpt.compile_plan(cql, {"S": schema})
    j = fpt.Job([plan], [fpt.BatchSource("S", schema, iter(bs))],
                batch_size=batch, time_mode="processing", device="cpu")
    j.run()
    return j


def _zoo_make(n=60, seed=3):
    rng = np.random.default_rng(seed)
    return {"id": rng.integers(0, 5, n).astype(np.int32),
            "price": np.round(rng.random(n) * 100, 2),
            "timestamp": 1000 + np.cumsum(rng.integers(1, 9, n))}


def test_zoo_sort_window_oracle_asc():
    cols = _zoo_make(50)
    rows = _zoo_run("from S#window.sort(3, price) select sum(price) as s, "
                    "count() as c, min(price) as mn insert into o",
                    cols).results("o")
    kept, exp = [], []
    for p in cols["price"]:
        kept = sorted(kept + [p])[:3]
        exp.append((sum(kept), len(kept), min(kept)))
    assert len(rows) == len(exp)
    for (s, c, mn), (es, ec, emn) in zip(rows, exp):
        assert c == ec
        assert s == pytest.approx(es, rel=1e-4)
        assert mn == pytest.approx(emn, rel=1e-4)


def test_zoo_sort_window_oracle_desc():
    cols = _zoo_make(50, seed=5)
    rows = _zoo_run("from S#window.sort(4, price, 'desc') select "
                    "max(price) as mx, count() as c insert into o",
                    cols).results("o")
    kept = []
    for (mx, c), p in zip(rows, cols["price"]):
        kept = sorted(kept + [p], reverse=True)[:4]
        assert c == len(kept)
        assert mx == pytest.approx(max(kept), rel=1e-4)
    assert len(rows) == 50


def test_zoo_unique_window_oracle():
    cols = _zoo_make(60, seed=7)
    rows = _zoo_run("from S#window.unique(id) select sum(price) as s, "
                    "count() as c insert into o", cols).results("o")
    latest = {}
    assert len(rows) == 60
    for (s, c), i, p in zip(rows, cols["id"], cols["price"]):
        latest[i] = p
        assert c == len(latest)
        assert s == pytest.approx(sum(latest.values()), rel=1e-4)


def test_zoo_session_window_oracle():
    cols = {"id": np.array([1, 2, 1, 1, 2, 1, 2], np.int32),
            "price": np.array([1.0, 10.0, 2.0, 4.0, 20.0, 8.0, 40.0]),
            "timestamp": np.array([1000, 1001, 1005, 1008, 1030, 1040,
                                   1041])}
    j = _zoo_run("from S#window.session(10 ms, id) select id, "
                 "sum(price) as s, count() as c insert into o", cols, 3)
    j.flush()
    rows = sorted(j.results("o"))
    exp = sorted([(1, 7.0, 3), (1, 8.0, 1), (2, 10.0, 1), (2, 20.0, 1),
                  (2, 40.0, 1)])
    assert len(rows) == len(exp)
    for (k, s, c), (ek, es, ec) in zip(rows, exp):
        assert (k, c) == (ek, ec)
        assert s == pytest.approx(es, rel=1e-5)


def test_zoo_frequent_window_oracle():
    cols = _zoo_make(120, seed=9)
    rows = _zoo_run("from S#window.frequent(2, id) select id, count() as c,"
                    " sum(price) as s insert into out", cols).results("out")
    table, latest, expect = {}, {}, []
    for i, p in zip(cols["id"].tolist(), cols["price"].tolist()):
        if i in table:
            table[i] += 1
            latest[i] = p
        elif len(table) < 2:
            table[i], latest[i] = 1, p
        else:
            table = {k: v - 1 for k, v in table.items()}
            for k in [k for k, v in table.items() if v == 0]:
                del table[k], latest[k]
            continue
        expect.append((i, len(table), sum(latest.values())))
    assert len(rows) == len(expect)
    for (i1, c1, s1), (i2, c2, s2) in zip(rows, expect):
        assert (i1, c1) == (i2, c2)
        assert s1 == pytest.approx(s2, rel=1e-4)


def test_zoo_lossy_frequent_window_oracle():
    cols = _zoo_make(150, seed=4)
    support, error = 0.3, 0.1
    rows = _zoo_run(f"from S#window.lossyFrequent({support}, {error}, id) "
                    "select id, count() as c insert into out",
                    cols).results("out")
    width = int(np.ceil(1.0 / error))
    table, n, expect = {}, 0, []
    for i in cols["id"].tolist():
        n += 1
        b = int(np.ceil(n / width))
        if i in table:
            table[i][0] += 1
        else:
            table[i] = [1, b - 1]
        if n % width == 0:
            for k in [k for k, (f, d) in table.items() if f + d <= b]:
                del table[k]
        thresh = (support - error) * n
        if i in table and table[i][0] >= thresh:
            expect.append((i, sum(1 for f, _ in table.values()
                                  if f >= thresh)))
    assert rows == expect and rows


def test_partition_sort_window_oracle():
    rng = np.random.default_rng(13)
    n = 240
    cols = {"k": rng.integers(0, 3, n).astype(np.int32),
            "v": np.round(rng.random(n) * 100, 2),
            "timestamp": 1000 + np.arange(n, dtype=np.int64)}
    rows = _zoo_run("partition with (k of S) begin from S#window.sort(4, v)"
                    " select k, min(v) as mn, count() as c insert into o "
                    "end", cols, 64, KVT).results("o")
    assert len(rows) == n
    kept = {k: [] for k in range(3)}
    for i, (k, mn, c) in enumerate(rows):
        b = kept[cols["k"][i]]
        b.append(cols["v"][i])
        b.sort()
        del b[4:]
        assert k == cols["k"][i] and c == len(b)
        assert mn == pytest.approx(min(b), rel=1e-4)


def test_partition_session_window_oracle():
    cols = {"k": np.array([0, 1, 0, 0, 1, 0, 1, 1], np.int32),
            "v": np.arange(1.0, 9.0),
            "timestamp": np.array([1000, 1002, 1005, 1040, 1041, 1100, 1101,
                                   1150])}
    j = _zoo_run("partition with (k of S) begin from S#window.session(10 ms)"
                 " select k, sum(v) as s, count() as c insert into o end",
                 cols, 4, KVT)
    j.flush()
    rows = sorted(j.results("o"))
    exp = sorted([(0, 4.0, 2), (0, 4.0, 1), (0, 6.0, 1), (1, 2.0, 1),
                  (1, 5.0, 1), (1, 7.0, 1), (1, 8.0, 1)])
    assert len(rows) == len(exp)
    for (k, s, c), (ek, es, ec) in zip(rows, exp):
        assert (k, c) == (ek, ec)
        assert s == pytest.approx(es, rel=1e-4)


# -- the artifacts' steps, state by state ----------------------------------

STEP_CASES = ("session_keyed", "session_stragglers", "session_int_past_2_24",
              "sort_partitioned", "sort_nan_key", "frequent", "lossy",
              "unique_int")


def _same_state(got, ref, path=""):
    """Every state array equal as stored (float32 by bit pattern, any NaN
    equal to any NaN)."""
    assert sorted(got) == sorted(ref), path
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, dict):
            _same_state(g, r, f"{path}.{k}")
            continue
        r = np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, f"{path}.{k}"
        if r.dtype == np.float32:
            nan = np.isnan(r)
            assert np.array_equal(np.isnan(g), nan), f"{path}.{k}"
            assert np.array_equal(g.view(np.int32)[~nan],
                                  r.view(np.int32)[~nan]), f"{path}.{k}"
        else:
            assert np.array_equal(g, r), f"{path}.{k}"


def _rows(plan, meta, buf):
    counts = np.asarray(meta)[0]
    n = int(counts.max())
    out = plan.drain_decode(counts, np.asarray(buf)[:, :n])["query_0"]
    return out[0][1] if out else []


@pytest.mark.parametrize("load_after", [0, 1], ids=["own", "loaded"])
@pytest.mark.parametrize("case", STEP_CASES)
def test_steps_match_the_reference(case, load_after):
    """Both plans step the same three tapes; after each the rows and the
    whole state agree. With ``loaded`` the port starts its second step
    from the reference's state (``state_from_numpy``, with the encoders)."""
    cql, *_, int_close = CASES[case]
    data = _data(case, 1536, 512)
    jschema, jb = batches("jax", data)
    tschema, tb = batches("torch", data)
    jplan = jax_compile(cql, {"S": jschema})
    tplan = fpt.compile_plan(cql, {"S": tschema})
    jstep = jax.jit(jplan.step_acc)
    jst, tst = jplan.init_state(), tplan.init_state("cpu")
    epoch = 1000
    for i in range(3):
        jt, _ = jax_build_tape(jplan.spec, [jb[i]], epoch)
        tt = torch_build_tape(tplan.spec, [tb[i]], epoch).to(
            torch.device("cpu"))
        jst, jacc = jstep(jplan.grow_state(jst), jplan.init_acc(), jt)
        if i == load_after == 1:
            enc = {e.out_key: e.encoder.state_dict()
                   for e in jplan.spec.encoded}
            tst = fpt.state_from_numpy(tplan, jax.device_get(prev), "cpu",
                                       encoders=enc)
        tst, tacc = tplan.step_acc(tplan.grow_state(tst),
                                   tplan.init_acc("cpu"), tt)
        prev = jst
        assert_rows_close(
            _rows(tplan, tacc["meta"].numpy(), tacc["buf"].numpy()),
            _rows(jplan, jacc["meta"], jacc["buf"]), int_close)
        _same_state(state_to_numpy(tst)["query_0"],
                    jax.device_get(jst)["query_0"], case)


def test_session_flush_matches_the_reference():
    cql = CASES["session_keyed"][0]
    data = _data("session_keyed")
    jjob = job("jax", cql, data, 512)
    tjob = job("torch", cql, data, 512)
    for j in (jjob, tjob):
        j.run()
        j.flush()
    ref, got = jjob.results_with_ts("out"), tjob.results_with_ts("out")
    assert_rows_close(got, ref)
    # the flush closed every open session: one row a key at the end
    assert len({r[0] for t, r in got if t == got[-1][0]}) >= 1
    st = tjob._plans["p"].states["query_0"]
    assert not bool(st["open"].any())


def test_lossy_victims_match_the_reference():
    """A full lossyFrequent table (every slot valid, built by hand and
    loaded into both packages) replaces its entry of least freq + delta,
    the lowest such slot."""
    cql = ("from S#window.lossyFrequent(0.35, 0.3, id) select id, "
           "count() as c, sum(price) as s insert into out")
    data = stream(512, 512, 300, seed=3)
    jschema, jb = batches("jax", data)
    tschema, tb = batches("torch", data)
    jplan = jax_compile(cql, {"S": jschema})
    tplan = fpt.compile_plan(cql, {"S": tschema})
    enc = {e.out_key: {"values": [(i,) for i in range(300)]}
           for e in jplan.spec.encoded}
    for e in jplan.spec.encoded:
        e.encoder.load_state_dict(enc[e.out_key])
    st = jax.device_get(jplan.init_state())
    C = st["query_0"]["valid"].shape[0]
    rng = np.random.default_rng(5)
    q = dict(st["query_0"])
    q["valid"] = np.ones(C, bool)
    q["code"] = np.arange(C, dtype=np.int32)
    q["freq"] = rng.integers(1, 4, C).astype(np.int32)
    q["delta"] = rng.integers(0, 3, C).astype(np.int32)
    q["seen"] = np.int32(40)
    q["a0"] = rng.random(C).astype(np.float32) * 100
    st["query_0"] = q
    tst = fpt.state_from_numpy(tplan, st, "cpu", encoders=enc)
    jt, _ = jax_build_tape(jplan.spec, [jb[0]], 1000)
    tt = torch_build_tape(tplan.spec, [tb[0]], 1000).to(torch.device("cpu"))
    jst, jacc = jax.jit(jplan.step_acc)(
        jax.tree_util.tree_map(np.asarray, st), jplan.init_acc(), jt)
    tst, tacc = tplan.step_acc(tst, tplan.init_acc("cpu"), tt)
    assert_rows_close(_rows(tplan, tacc["meta"].numpy(), tacc["buf"].numpy()),
                      _rows(jplan, jacc["meta"], jacc["buf"]))
    _same_state(state_to_numpy(tst)["query_0"],
                jax.device_get(jst)["query_0"])
    # the table held other codes at the start: new ones took victims
    assert not np.array_equal(state_to_numpy(tst)["query_0"]["code"],
                              np.arange(C))


# -- no host read in a step --------------------------------------------------

@pytest.mark.parametrize("case", ["session_keyed", "sort_partitioned",
                                  "lossy", "unique_int"])
def test_segment_body_makes_no_host_read(case, monkeypatch):
    """A scan window's step reads nothing on the host, what a CUDA graph
    could not capture: the segment body under the host-read guard of
    tests/test_torch_segments.py, with the kernel call itself (on the card
    one launch; here its plain version, which reads on the host) run with
    the guard paused and its outputs marked derived."""
    from test_torch_segments import HostReadGuard

    from flink_siddhi_tpu_torch.runtime.graphs import step_segment

    j = job("torch", CASES[case][0], _data(case), 512, retain=False)
    rep = fpt.ResidentReplay(j)
    rep.stage()
    (rt,) = j._plans.values()
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
    for name in ("session_scan", "frequency_scan", "sort_window_scan",
                 "unique_window_fold"):
        real = getattr(scan_windows, name)

        def paused(*args, _real=real):
            calls.append(args)
            guard.paused = True
            try:
                out = _real(*args)
            finally:
                guard.paused = False
            for t in out:
                guard._mark(t)
            return out

        monkeypatch.setattr(scan_windows, name, paused)
    with guard:
        _, acc = step_segment(rt.plan, rt.states, rt.acc, tapes)
    assert len(calls) == len(tapes)
    assert int(acc["meta"][0].sum()) > 0


def test_the_kernels_grouping_makes_no_host_read():
    """The glue K7 and K9 run on the card before their launch (a stable
    sort of the masked events by key and a search for each key's range)
    under the host-read guard, against a plain loop."""
    from test_torch_segments import HostReadGuard

    rng = np.random.default_rng(1)
    mask = torch.from_numpy(rng.random(500) < 0.7)
    keys = torch.from_numpy(rng.integers(0, 9, 500).astype(np.int32))
    with HostReadGuard([mask, keys]):
        order, starts = cuda_ops._grouped(mask, keys, 9)
    for k in range(9):
        want = [t for t in range(500) if mask[t] and keys[t] == k]
        assert order[int(starts[k]):int(starts[k + 1])].tolist() == want
    assert int(starts[-1]) == int(mask.sum())


@pytest.mark.parametrize("case", ["session_keyed", "sort_asc", "frequent",
                                  "unique_int"])
def test_resident_and_fused_rows_equal_streaming(case):
    cql, *_ = CASES[case]
    data = _data(case)
    rows, _ = run("torch", cql, data, 512)
    res, _ = run("torch", cql, data, 512, resident=True)
    assert res == rows
    fused = job("torch", cql, data, 512)
    fused.fused_segment_len = 2
    fused.run()
    assert fused.results_with_ts("out") == rows
    assert fused.eager_segments == 0
