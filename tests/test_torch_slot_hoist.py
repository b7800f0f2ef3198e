"""The slot NFA's cross-element filters after the scan's redesign, on the CPU:
the event-only conjuncts hoisted into the element masks, ``/`` and ``%`` in
the slot program, programs of any depth and length, function calls over
the event as derived columns, pools past 1,024 slots, and the capture guard
that keeps a graph capture clear of other Jobs.

Each query runs in the JAX package (the reference) and in the port (its
plain scan) on the same seeded numpy streams (tests/torch_slot_common.py);
the rows are compared exactly. The patterns run at batch 8,192 on both of
the reference's branches: its compacted scan (at most E/8 relevant events,
50 ids) and its full-scan fallback (6 ids). The program's arithmetic is
held bit for bit to ``jnp.floor_divide``, ``jnp.divide`` and ``jnp.mod``
(XLA's integer division by zero and ``INT_MIN // -1`` included), and each
filter to the reference's ``compile_expr`` on random columns with 0,
negatives, ``INT_MIN``, -1, NaN, +-inf and -0.0.
"""

import gc
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_siddhi_tpu.compiler import nfa as jnfa
from flink_siddhi_tpu.compiler.expr import compile_expr as jax_compile_expr
from flink_siddhi_tpu.query.parser import parse_plan as jax_parse_plan
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler import nfa, slot_program
from flink_siddhi_tpu_torch.compiler.slot_program import eval_program
from flink_siddhi_tpu_torch.query import parse_plan
from flink_siddhi_tpu_torch.query.lexer import SiddhiQLError
from flink_siddhi_tpu_torch.runtime import graphs

from torch_slot_common import FIELDS, artifact, assert_same_rows, columns

torch.set_num_threads(2)

INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
BATCH = 8192

# (query, element: its hoisted conjuncts' columns and values)
HOISTED = {
    # chip_smoke.py's query (c)
    "cross": (
        "from every s1 = S[id == 1] -> s2 = S[id == 2 and price > s1.price] "
        "within 1 sec select s1.price as p1, s2.price as p2, "
        "s2.timestamp as t2 insert into o"),
    # two hoisted conjuncts around a cross one, and a second cross element
    "two_elements": (
        "from every s1 = S[id == 1] -> s2 = S[price > s1.price and id == 2 "
        "and name == 'beta'] -> s3 = S[id == 3 and "
        "timestamp - s1.timestamp < 800] within 2 sec select s1.price as p1,"
        " s2.price as p2, s3.timestamp as t3 insert into o"),
    # a quantified cross element
    "quantified": (
        "from every s1 = S[id == 1] -> s2 = S[id == 2 and "
        "price >= s1.price]<1:3> -> s3 = S[id == 3] within 1 sec "
        "select s1.price as p1, s2[0].price as f2, s2[last].price as l2, "
        "s3.timestamp as t3 insert into o"),
}


def _stream(n_ids, seed=3):
    return {"S": columns(2 * BATCH, n_ids, seed=seed, step_ms=1)}


def _plan(cql, **config):
    schema = fpt.StreamSchema(FIELDS)
    return fpt.compile_plan(cql, {"S": schema},
                            config=fpt.EngineConfig(**config))


def _full_program_len(cql, k):
    """Words of element k's whole filter as one program (no hoist)."""
    schema = fpt.StreamSchema(FIELDS)
    art = _plan(cql).artifacts[0]
    el = parse_plan(cql).queries[0].input.elements[k]
    spec = art.spec
    resolver = nfa._ElemFilterResolver(
        k, el, schema, spec.elements,
        nfa.CaptureResolver(spec.elements, {"S": schema}), [],
        {i: i for i in range(spec.n_elements)},
    )
    prog = slot_program.compile_slot_program(el.filter, resolver,
                                             lambda key: key.startswith("S."))
    return len(prog.link(lambda key: 0, lambda key: 0))


@pytest.mark.parametrize("n_ids", [50, 6], ids=["compacted", "full_scan"])
@pytest.mark.parametrize("name", sorted(HOISTED))
def test_hoisted_cross_filters_match_jax(name, n_ids):
    cql = HOISTED[name]
    data = _stream(n_ids)
    rel = np.isin(data["S"]["id"][:BATCH], [1, 2, 3]).sum()
    assert (rel <= BATCH // 8) == (n_ids == 50)
    assert_same_rows(cql, data, BATCH, min_rows=5)
    # the hoisted conjunct is the element's mask; the program is shorter
    art = _plan(cql).artifacts[0]
    spec = art.spec
    ids = torch.from_numpy(data["S"]["id"][:64])
    env = {"S.id": ids, "S.name": torch.zeros(64, dtype=torch.int32),
           "S.price": torch.zeros(64), "S.timestamp": torch.zeros(
               64, dtype=torch.int32)}
    for k, prog in enumerate(spec.cross_fns):
        if prog is None:
            continue
        mask = spec.pred_fns[k](env)
        assert torch.equal(mask & (ids != 1 + k), torch.zeros_like(mask))
        assert len(art.scan_plan.cross[k]) < _full_program_len(cql, k)


@pytest.mark.parametrize("cql", [
    # an `or` at the top: nothing hoisted
    "from every s1 = S[id == 1] -> s2 = S[id == 2 or price > s1.price] "
    "within 1 sec select s1.price as p1, s2.id as i2 insert into o",
    # a conjunct that reads a capture stays, with its `or` inside
    "from every s1 = S[id == 1] -> s2 = S[(price > s1.price or id == 3) "
    "and s1.id == 1] within 1 sec select s1.price as p1, s2.id as i2 "
    "insert into o",
])
def test_or_and_capture_conjuncts_stay_in_the_program(cql):
    assert_same_rows(cql, _stream(6), BATCH, min_rows=5)
    art = _plan(cql).artifacts[0]
    assert art.spec.pred_fns[1] is None
    assert len(art.scan_plan.cross[1]) == _full_program_len(cql, 1)


def test_first_element_cross_filter_refused_as_the_reference():
    # the reference accepts no cross filter on a first-group element: it
    # can only reference earlier elements
    cql = ("from every s1 = S[id == 1 and price > s2.price] -> s2 = S[id == 2]"
           " select s1.price as p1 insert into o")
    with pytest.raises(Exception, match="EARLIER"):
        jnfa._build_spec(jax_parse_plan(cql).queries[0],
                         {"S": JaxSchema(FIELDS)}, {"S": 0}, None)
    with pytest.raises(SiddhiQLError, match="EARLIER"):
        _plan(cql)


# -- `/` and `%` --------------------------------------------------------------

SPECIAL_I = np.array([0, 1, -1, 2, -2, 3, -7, 7, INT_MIN, INT_MAX,
                      INT_MIN + 1, 100], np.int32)
SPECIAL_F = np.array([0.0, -0.0, 1.0, -1.0, 2.5, -2.5, 7.0, np.inf, -np.inf,
                      np.nan, 1e-30, -3e38], np.float32)


def _int_pairs():
    a, b = np.meshgrid(SPECIAL_I, SPECIAL_I)
    rng = np.random.default_rng(1)
    ra = rng.integers(INT_MIN, INT_MAX, 4096, dtype=np.int64).astype(np.int32)
    rb = rng.integers(-9, 10, 4096).astype(np.int32)
    return np.concatenate([a.ravel(), ra]), np.concatenate([b.ravel(), rb])


def _float_pairs():
    a, b = np.meshgrid(SPECIAL_F, SPECIAL_F)
    rng = np.random.default_rng(2)
    ra = (rng.standard_normal(4096) * 100).astype(np.float32)
    rb = (rng.standard_normal(4096) * 10).astype(np.float32)
    return np.concatenate([a.ravel(), ra]), np.concatenate([b.ravel(), rb])


@pytest.mark.parametrize("op", ["floor_divide", "mod"])
def test_int_division_matches_jnp_bit_for_bit(op):
    a, b = _int_pairs()
    ref = np.asarray(getattr(jnp, op)(jnp.asarray(a), jnp.asarray(b)))
    fn = {"floor_divide": slot_program._floor_div_i,
          "mod": slot_program._mod_i}[op]
    got = fn(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    # the cases C++ leaves undefined
    if op == "floor_divide":
        assert ref[(a == INT_MIN) & (b == -1)].tolist()[0] == INT_MIN
        assert set(ref[(b == 0) & (a != 0)].tolist()) == {-2}
        assert ref[(b == 0) & (a == 0)].tolist()[0] == -1
    else:
        assert set(ref[b == 0].tolist()) == {0}


@pytest.mark.parametrize("op", ["divide", "mod"])
def test_float_division_matches_jnp_bit_for_bit(op):
    a, b = _float_pairs()
    ref = np.asarray(getattr(jnp, op)(jnp.asarray(a), jnp.asarray(b)))
    wa = torch.from_numpy(a.view(np.int32))
    wb = torch.from_numpy(b.view(np.int32))
    code = slot_program.OP_DIV_F if op == "divide" else slot_program.OP_MOD_F
    got = slot_program._BINARY[code](wa, wb).numpy().view(np.float32)
    same = (got.view(np.int32) == ref.view(np.int32)) | (
        np.isnan(got) & np.isnan(ref))
    # XLA on the CPU flushes subnormal operands and results (FTZ + DAZ);
    # the port flushes the same way (expr.ftz), so they are equal there too
    assert same.all(), (a[~same][:5], b[~same][:5], got[~same][:5],
                        ref[~same][:5])


DIV_PROGRAMS = [
    "id / s1.id == 2",
    "id % s1.id == 1",
    "timestamp / s1.timestamp < 0",
    "timestamp % s1.timestamp == 0",
    "price / s1.price > 1.5",
    "price % s1.price < 2.0",
    "-price % s1.price >= 0.5 or price / s1.price == price",
    "id / s1.price < 3.0",
    "(id - s1.id) % 7 != 3 and timestamp / 1000 > s1.id",
    "price % (s1.price - s1.price) != price",
    "id % (s1.id - s1.id) == 0 and id / (s1.id - s1.id) < 0",
]


def _column(name, rng, n):
    if name == "price":
        v = np.concatenate([SPECIAL_F, (rng.standard_normal(n) * 50)
                            .astype(np.float32)])
        return rng.permutation(v)[:n].astype(np.float32)
    if name == "name":
        return rng.integers(0, 3, n).astype(np.int32)
    v = np.concatenate([SPECIAL_I, rng.integers(-9, 10, n).astype(np.int32)])
    return rng.permutation(v)[:n].astype(np.int32)


@pytest.mark.parametrize("expr", DIV_PROGRAMS)
def test_division_programs_equal_the_reference_compile_expr(expr):
    """The program (what the scan runs, on the card and in the plain
    version) against the reference's compile_expr closure, on columns
    holding 0, -1, INT_MIN, NaN, +-inf and -0.0."""
    cql = (f"from every s1 = S[id > 0]+ -> s2 = S[{expr}] "
           "select s1.id as a insert into o")
    art = _plan(cql).artifacts[0]
    spec = art.spec
    code = art.scan_plan.cross[1]
    assert code is not None and spec.pred_fns[1] is None
    jschema = JaxSchema(FIELDS)
    jel = jax_parse_plan(cql).queries[0].input.elements
    jres = jnfa._ElemFilterResolver(
        1, jel[1], jschema, jel, jnfa.CaptureResolver(jel, {"S": jschema}),
        [], {0: 0, 1: 1})
    fn = jax_compile_expr(jel[1].filter, jres).fn
    rng = np.random.default_rng(5)
    N = 2048
    env = {key: _column(key.rsplit(".", 1)[-1], rng, N) for key in art._cols}
    for e, c, w in spec.captures:
        env[nfa._cap_key(spec.elements[e].alias, w, c)] = _column(c, rng, N)
    ref = np.broadcast_to(np.asarray(fn({k: jnp.asarray(v)
                                         for k, v in env.items()})), (N,))

    def word(v):
        return torch.from_numpy(v.view(np.int32) if v.dtype == np.float32
                                else v)

    cols = [word(env[key]) for key in art._cols]
    pairs = nfa._cap_pairs(spec)
    caps = {2 * pairs.index((e, c)) + (w == "last"):
            word(env[nfa._cap_key(spec.elements[e].alias, w, c)])
            for e, c, w in spec.captures}
    got = eval_program(code, lambda c: cols[c], lambda w: caps[w])
    assert np.array_equal((got != 0).numpy(), ref)


def test_division_filters_give_the_reference_rows():
    cql = ("from every s1 = S[id == 1] -> s2 = S[id == 2 and "
           "(price / s1.price > 1.2 or timestamp % (s1.id + 3) == 1 or "
           "price % (s1.price - 50.0) < 3.0)] within 1 sec "
           "select s1.price as p1, s2.price as p2 insert into o")
    assert_same_rows(cql, _stream(6), BATCH, min_rows=5)


# -- deep and long programs, derived columns ---------------------------------

# price > s1.price - 10, 22 entries deep
DEEP = ("from every s1 = S[id == 1] -> s2 = S[id == 2 and price > "
        + "".join(f"({k} - " for k in range(20)) + "s1.price" + ")" * 20
        + "] within 1 sec select s1.price as p1, s2.price as p2 insert into o")
LONG = ("from every s1 = S[id == 1] -> s2 = S["
        + " and ".join(f"price != s1.price + {k}" for k in range(115))
        + "] within 60 ms select s1.price as p1, s2.price as p2 insert into o")


def test_deep_and_long_programs_give_the_reference_rows():
    art = _plan(DEEP).artifacts[0]
    assert art.scan_plan.depth > 16
    assert_same_rows(DEEP, _stream(6), BATCH, min_rows=5)
    art = _plan(LONG).artifacts[0]
    assert len(art.scan_plan.cross[1]) > 1024
    data = {"S": columns(1024, 10, seed=4, step_ms=20)}
    assert_same_rows(LONG, data, 512, min_rows=5)


@pytest.mark.parametrize("expr", [
    "math:abs(price) > s1.price",
    "math:sqrt(price) < s1.price",
    "id == 2 and math:abs(price - 50.0) * 2 > s1.price",
])
def test_event_only_calls_become_derived_columns(expr):
    cql = (f"from every s1 = S[id == 1] -> s2 = S[{expr}] within 1 sec "
           "select s1.price as p1, s2.price as p2 insert into o")
    data = _stream(6)
    data["S"]["price"] = data["S"]["price"] - 50.0  # negatives for abs
    assert_same_rows(cql, data, BATCH, min_rows=5)
    art = _plan(cql).artifacts[0]
    derived = [k for k in art._cols if k in art.spec.derived_fns]
    assert len(derived) == 1


def test_call_over_a_capture_names_its_roadmap_item():
    with pytest.raises(SiddhiQLError, match="item 8"):
        _plan("from every s1 = S[id == 1] -> s2 = S[price > "
              "math:abs(s1.price)] select s1.price as p1 insert into o")


# -- pools past 1,024 slots ----------------------------------------------------

def test_pattern_slots_2048_gives_the_reference_rows_and_4096_compiles():
    cql = ("from every s1 = S[id < 3] -> s2 = S[id == 4]<2:3> -> "
           "s3 = S[id == 5] select s1.price as p1, s2[1].price as p2, "
           "s3.timestamp as t3 insert into o")
    data = {"S": columns(3072, 40, seed=8, step_ms=1)}
    _, _, tjob = assert_same_rows(cql, data, 1024, min_rows=5,
                                  pattern_slots=2048)
    assert artifact(tjob).scan_plan.slots == 2048
    plan = _plan(cql, pattern_slots=4096).artifacts[0].scan_plan
    assert plan.slots == 4096 and plan.words()


# -- the capture guard (`chip_smoke.py --ab-graphs`) --------------------------

class _Cyclic:
    """Stands for a dropped Job's CUDA graph: it sits in a reference cycle
    and its finalizer would destroy the graph (``CUDAGraph::reset``)."""

    def __init__(self, log, tag):
        self.log, self.tag, self.me = log, tag, self

    def __del__(self):
        self.log.append(self.tag)


def test_capture_guard_frees_garbage_first_and_none_during():
    # a capture in "global" mode is invalidated by a CUDA graph destroyed
    # from any thread: a dropped Job's graphs collected mid-capture made
    # `chip_smoke.py --ab-graphs` fail
    log = []
    _Cyclic(log, "dropped before")
    with graphs.capture_guard():
        log.append("capture")
        _Cyclic(log, "dropped during")
        junk = [[i] for i in range(200_000)]  # would run the collector
        del junk
        log.append("captured")
    gc.collect()
    assert log == ["dropped before", "capture", "captured", "dropped during"]
    assert gc.isenabled()


def test_a_capture_waits_for_every_live_jobs_fetches():
    """Job A's fetch is running (held) when Job B is about to capture: B's
    settle waits for it, then A's run loop completes it as usual."""
    from test_torch_drain import _Gate, _filter_job

    job_a, rt_a = _filter_job()
    job_b, _ = _filter_job()
    gate = _Gate(job_a)
    job_a.run_cycle()
    job_a._drain_request(rt_a)
    job_a._drain_poll(rt_a)  # hands the fetch to A's thread (held)
    entry = rt_a.drain_q[-1]
    assert "fut" in entry and not entry["fut"].done()
    opened = []

    def release():
        time.sleep(0.2)
        opened.append(time.monotonic())
        gate.open.set()

    t = threading.Thread(target=release)
    t.start()
    job_b._settle_drains()
    t.join()
    assert entry["fut"].done() and opened
    job_a.close()
    assert not rt_a.drain_q and job_a._fetch_pool_ is None
    job_a.run()  # a closed job drains again on a new fetch thread
    job_b.run()
    assert job_a.results_with_ts("matches") == job_b.results_with_ts(
        "matches")


def test_hoisted_and_derived_slot_step_makes_no_host_read(monkeypatch):
    """The hoisted mask and a derived column are torch ops in the slot
    step; like the rest of it they read nothing on the host, so a slot
    segment still captures (the segment body under the host-read guard of
    tests/test_torch_segments.py, the scan itself run with the guard
    paused, as tests/test_torch_slot_nfa.py runs it)."""
    from test_torch_segments import HostReadGuard

    from flink_siddhi_tpu_torch.compiler import cuda_ops
    from flink_siddhi_tpu_torch.runtime.graphs import step_segment

    cql = ("from every s1 = S[id == 1] -> s2 = S[id == 2 and "
           "math:abs(price - 50.0) > s1.price % 7.0] within 1 sec "
           "select s1.price as p1, s2.price as p2 insert into o")
    schema = fpt.StreamSchema(FIELDS)
    data = columns(3 * 4096, 30, seed=53, step_ms=1)
    data["name"] = data["name"].astype(np.int32)
    batches = [
        fpt.EventBatch("S", schema, {k: v[s:s + 4096]
                                     for k, v in data.items()},
                       data["timestamp"][s:s + 4096])
        for s in range(0, 3 * 4096, 4096)
    ]
    plan = fpt.compile_plan(
        cql, {"S": schema}, plan_id="p",
        config=fpt.EngineConfig(lazy_projection=True, pred_pushdown=True))
    art = plan.artifacts[0]
    assert art.spec.pred_fns[1] is not None and art.spec.derived_fns
    job = fpt.Job([plan], [fpt.BatchSource("S", schema, iter(batches))],
                  batch_size=4096, time_mode="processing",
                  retain_results=False, device="cpu")
    rep = fpt.ResidentReplay(job)
    rep.stage()
    rt = job._plans["p"]
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

    def scan(*args):
        calls.append(args)
        guard.paused = True
        try:
            out = cuda_ops.slot_nfa_scan_plain(*args)
        finally:
            guard.paused = False
        for t in out:
            guard._mark(t)
        return out

    monkeypatch.setattr(nfa, "slot_nfa_scan", scan)
    with guard:
        _, acc = step_segment(rt.plan, rt.states, rt.acc, tapes)
    assert len(calls) == len(tapes)
    assert int(acc["meta"][0].sum()) > 0


def test_capture_guards_on_two_threads_share_one_hold():
    """The collector stays off until the last of two overlapping captures
    ends: the first to end must not turn it back on under the other."""
    entered, release = threading.Event(), threading.Event()
    seen = []

    def other():
        with graphs.capture_guard():
            entered.set()
            release.wait(10)
            seen.append(gc.isenabled())

    t = threading.Thread(target=other)
    with graphs.capture_guard():
        t.start()
        assert entered.wait(10)
    seen.append(gc.isenabled())  # the other capture still holds it
    release.set()
    t.join(10)
    assert seen == [False, False]
    assert gc.isenabled()


class _Graph:
    """Stands for a captured CUDA graph: its destruction is logged."""

    def __init__(self, log):
        self.log = log

    def __del__(self):
        self.log.append("graph destroyed")


class _Runtime:
    """Stands for a dropped Job's segment runtime, in a reference cycle."""


def test_a_collected_runtimes_graphs_wait_for_the_next_capture():
    # registered as SegmentGraphs registers its table on a CUDA device
    import weakref

    log = []
    rt = _Runtime()
    rt.me = rt
    rt.graphs = {"key": [_Graph(log)]}
    graphs._TABLES[id(rt)] = rt.graphs
    weakref.finalize(rt, graphs._bury, id(rt))
    gc.collect()  # the runtime is old: the guard's young pass skips it
    del rt
    with graphs.capture_guard():
        log.append("capture")
        gc.collect()  # a collection inside the capture
        log.append("captured")
    with graphs.capture_guard():
        log.append("next capture")
    assert log == ["capture", "captured", "graph destroyed", "next capture"]
    assert not graphs._BURIED
