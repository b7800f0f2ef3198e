"""The torch port's slot NFA (``SlotNFAArtifact``, the slot scan K4 through
its plain version) against the JAX package's, on the CPU.

Each test makes its streams with numpy from a seed, hands the same columns
to both packages and runs the same SiddhiQL through ``compile_plan`` ->
``Job`` (tests/torch_slot_common.py). Timestamps, ints, strings and counts
are compared exactly, float captures bitwise (they are copies of float32
columns), computed projections within rtol 1e-6.

Covered: the slot-NFA pattern forms of tests/test_pattern_e2e.py (its CQL
strings, over random two-stream input); the zoo's slot_nfa_quantified and
sequence at batch 8,192 with at most and with more than E/8 relevant
events (both of the reference's branches: its compacted scan and its
full-scan fallback); partials carried across micro-batches; a pool of 4
slots that overflows; the JAX plan's slot state loaded mid-stream through
``state_from_numpy``; a computed projection; the cross-filter program
against ``compile_expr``'s function on random columns; the forms outside
the program; the artifact classes of the bench configs and the ported
zoo plans, unchanged; the fused streaming Job's rows; and the slot step
under a host-read guard.
"""

import re

import jax
import numpy as np
import pytest
import torch

from flink_siddhi_tpu.analysis.zoo import PLAN_ZOO
from flink_siddhi_tpu.compiler.config import EngineConfig as JaxConfig
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.tape import build_tape as jax_build_tape
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler import nfa
from flink_siddhi_tpu_torch.compiler.config import EngineConfig
from flink_siddhi_tpu_torch.compiler.expr import compile_expr
from flink_siddhi_tpu_torch.compiler.plan import state_to_numpy
from flink_siddhi_tpu_torch.compiler.slot_program import eval_program
from flink_siddhi_tpu_torch.query import parse_plan
from flink_siddhi_tpu_torch.query.lexer import SiddhiQLError
from flink_siddhi_tpu_torch.runtime.tape import build_tape as torch_build_tape

from torch_slot_common import (
    FIELDS, artifact, assert_same_rows, columns, run,
)

torch.set_num_threads(2)

# the slot-NFA forms of tests/test_pattern_e2e.py, as written there
PATTERN_E2E = [
    "from every s1 = inputStream1[id == 2]+ , "
    "s2 = inputStream2[id == 3]? within 1000 second "
    "select s1[0].name as n1, s2.name as n2 insert into outputStream",
    "from s1 = inputStream1[id == 2]+ , s2 = inputStream1[id == 3] "
    "select s1[0].price as first_p, s1[last].price as last_p, "
    "s2.price as close_p insert into outputStream",
    "from every s1 = inputStream1[id == 2]<2:2> -> "
    "s2 = inputStream1[id == 3] "
    "select s1[0].timestamp as t1, s1[last].timestamp as t2, "
    "s2.timestamp as t3 insert into outputStream",
    "from every s1 = inputStream1[id == 2] , s2 = inputStream1[id == 3] "
    "select s1.timestamp as t1, s2.timestamp as t2 "
    "insert into outputStream",
    "from s1 = inputStream1[id == 2] , s2 = inputStream1[id == 3] "
    "select s1.id as a, s2.id as b insert into outputStream",
    "from every s1 = S[id == 1]+ -> s2 = S[id == 2] "
    "select s1[0].price as p0, s1[last].price as pl, "
    "s2.price as p2 insert into o",
    "from every s1 = inputStream1[id == 2]<3:3> -> "
    "s2 = inputStream1[id == 3] "
    "select s1[0].price as p0, s1[1].price as p1, s1[2].price as p2, "
    "s1[last].price as pl insert into outputStream",
    "from every s1 = inputStream1[id == 2]<1:3> -> "
    "s2 = inputStream1[id == 3] "
    "select s1[0].price as p0, s1[1].price as p1 "
    "insert into outputStream",
    "from every s1 = inputStream1[id == 2]<2:2> -> "
    "s2 = inputStream1[id == 3 and price > s1[1].price] "
    "select s1[1].price as p1, s2.price as pc "
    "insert into outputStream",
    "from every s1 = inputStream1[id == 2]<2:2> -> "
    "s2 = inputStream1[id == 3] "
    "select s1[1].price as p1 insert into outputStream",
    "from every (s1 = inputStream1[id == 2] -> "
    "s2 = inputStream2[id == 3]) "
    "select s1.timestamp as t1, s2.timestamp as t2 "
    "insert into outputStream",
    "from every (s1 = inputStream1[price > 0] -> "
    "s2 = inputStream1[price > 1]) "
    "select s1.timestamp as t1, s2.timestamp as t2 "
    "insert into outputStream",
    "from s1 = inputStream1[id == 1] -> every s2 = inputStream1[id == 2] "
    "select s1.timestamp as t1, s2.timestamp as t2 "
    "insert into outputStream",
    "from s1 = inputStream1[id == 1] -> every s2 = inputStream1[id == 2] "
    "-> s3 = inputStream1[id == 3] "
    "select s2.timestamp as t2, s3.timestamp as t3 "
    "insert into outputStream",
    "from every s1 = inputStream1[id == 1] -> "
    "every s2 = inputStream1[id == 2] "
    "select s1.timestamp as t1, s2.timestamp as t2 "
    "insert into outputStream",
    "from s1 = inputStream1[id == 1] -> every s2 = inputStream1[id == 2] "
    "within 10 sec "
    "select s1.timestamp as t1, s2.timestamp as t2 "
    "insert into outputStream",
]


def _streams_of(cql, n_events, n_ids, seed):
    """Every stream the CQL reads, with its own seeded columns (the
    streams interleave in time)."""
    sids = sorted(set(re.findall(r"(\w+)\[", cql)))
    return {sid: columns(n_events, n_ids, seed + i, t0=1000 + 7 * i)
            for i, sid in enumerate(sids)}


@pytest.mark.parametrize("cql", PATTERN_E2E,
                         ids=[f"e2e{i}" for i in range(len(PATTERN_E2E))])
def test_pattern_e2e_forms_match_jax(cql):
    out = re.search(r"insert into (\w+)", cql).group(1)
    streams = _streams_of(cql, 1024, 5, seed=31)
    ref, jjob, tjob = assert_same_rows(cql, streams, 256, out=out)
    # every form here needs the slot engine, in both packages
    assert type(artifact(tjob)).__name__ == "SlotNFAArtifact"
    assert type(artifact(jjob)).__name__ == "SlotNFAArtifact"
    # a non-every form matches at most once; the others produce rows
    assert ref or not cql.split()[1] == "every"


@pytest.mark.parametrize("n_ids", [50, 6], ids=["compacted", "full_scan"])
@pytest.mark.parametrize("name", ["slot_nfa_quantified", "sequence"])
def test_zoo_slot_plans_match_jax_on_both_branches(name, n_ids):
    """At batch 8,192 the reference compacts a '->' pattern's relevant
    events into E/8 when at most that many are relevant (ids 1-3 of 50:
    6%), else it scans the full tape (of 6 ids: half); the port always
    scans the relevant events, and its rows are the reference's either
    way. A sequence scans every event in both."""
    data = {"S": columns(2 * 8192, n_ids, seed=3, step_ms=1)}
    rel = np.isin(data["S"]["id"][:8192], [1, 2, 3]).sum()
    assert (rel <= 8192 // 8) == (n_ids == 50)
    assert_same_rows(PLAN_ZOO[name], data, 8192, out="out", min_rows=5)


def test_partials_carry_across_micro_batches():
    cql = (
        "from every s1 = S[id == 1] -> s2 = S[id == 2]<2:3> -> "
        "s3 = S[id == 3] select s1.timestamp as t1, s2[1].timestamp as t2, "
        "s3.timestamp as t3 insert into o"
    )
    data = {"S": columns(16 * 64, 30, seed=5, step_ms=1)}
    ref, _, _ = assert_same_rows(cql, data, 64, min_rows=5)
    crossed = [r for _, r in ref if (r[0] - 1000) // 64 < (r[2] - 1000) // 64]
    assert len(crossed) >= 3


def test_slot_pool_overflow_matches_jax():
    # every without within pins partials; a pool of 4 slots overflows
    cql = (
        "from every s1 = S[id < 12] -> s2 = S[id == 29]<2:2> "
        "select s1.price as p1, s2[1].timestamp as t2 insert into o"
    )
    data = {"S": columns(6 * 256, 30, seed=9)}
    _, jjob, tjob = assert_same_rows(cql, data, 256, pattern_slots=4)
    jover = int(np.asarray(jjob._plans["p"].states["query_0"]["overflow"]))
    tover = int(tjob._plans["p"].states["query_0"]["overflow"])
    assert jover == tover > 0


def test_computed_projection_within_rtol():
    cql = (
        "from every s1 = S[id == 1] -> s2 = S[id == 2 and price > s1.price]"
        " within 2 sec select s2.price - s1.price as gain, "
        "s1.price * 3 + s2.price as mix, s2.id as i insert into o"
    )
    data = {"S": columns(2048, 8, seed=17)}
    assert_same_rows(cql, data, 512, min_rows=20, rtol=1e-6)


def test_jax_slot_state_loaded_mid_stream():
    """The JAX plan steps batch 1; its slot state, fetched as numpy (or
    members, indexed captures and their validity bits included), seeds the
    port's plan; both step batch 2 from the same carried partials, to the
    same rows and the same state."""
    cql = (
        "from every s1 = S[id == 1] -> (a = S[id == 2] or b = S[id == 4]) "
        "-> s3 = S[id == 3]<1:3> within 1 sec select s1.price as p1, "
        "a.price as pa, b.name as nb, s3[1].price as p31, "
        "s3[last].timestamp as t3, s1.timestamp as t1 insert into o"
    )
    data = columns(2 * 2048, 6, seed=21, step_ms=5)
    jplan = jax_compile(cql, {"S": JaxSchema(FIELDS)})
    tplan = fpt.compile_plan(cql, {"S": fpt.StreamSchema(FIELDS)})

    def batch(Schema, Batch, lo):
        schema = Schema(FIELDS)
        cols = {k: v[lo:lo + 2048] for k, v in data.items()}
        cols["name"] = cols["name"].astype(np.int32)
        return Batch("S", schema, cols, cols["timestamp"])

    epoch = 1000
    jstep = jax.jit(jplan.step_acc)
    jt1, _ = jax_build_tape(jplan.spec, [batch(JaxSchema, JaxBatch, 0)],
                            epoch)
    jst, _ = jstep(jplan.init_state(), jplan.init_acc(), jt1)
    carried = jax.device_get(jst)
    assert carried["query_0"]["active"].any()
    assert set(carried["query_0"]) >= {"idx1:3:price", "idxv1:3:price",
                                       "started", "matched"}

    tst = fpt.state_from_numpy(tplan, carried, "cpu")
    jt2, _ = jax_build_tape(jplan.spec, [batch(JaxSchema, JaxBatch, 2048)],
                            epoch)
    tt2 = torch_build_tape(
        tplan.spec, [batch(fpt.StreamSchema, fpt.EventBatch, 2048)], epoch
    ).to(torch.device("cpu"))
    jst2, jacc = jstep(jst, jplan.init_acc(), jt2)
    tst2, tacc = tplan.step_acc(tst, tplan.init_acc("cpu"), tt2)

    def rows(plan, meta, buf):
        counts = np.asarray(meta)[0]
        n = int(counts.max())
        return plan.drain_decode(counts, np.asarray(buf)[:, :n])["query_0"]

    jrows = rows(jplan, jacc["meta"], jacc["buf"])[0][1]
    trows = rows(tplan, tacc["meta"].numpy(), tacc["buf"].numpy())[0][1]
    assert trows == jrows and len(jrows) >= 10
    assert any(r[1] is None for _, r in jrows)  # an unfired or member
    # some batch-2 matches started from partials carried out of batch 1
    assert any(r[5] < 1000 + 2048 * 5 for _, r in jrows)
    jfinal = jax.device_get(jst2)["query_0"]
    tfinal = state_to_numpy(tst2)["query_0"]
    assert set(jfinal) == set(tfinal)
    for k in jfinal:
        assert np.array_equal(np.asarray(jfinal[k]), tfinal[k]), k


# cross-element filters over the event's own columns and s1's captures
PROGRAMS = [
    "price > s1.price",
    "price + 1 > s1.price * 2.0",
    "id == s1.id and price - s1.price <= 10.5",
    "not (id != 3) or price * 3 < s1.price + 2",
    "-price < -s1.price",
    "id * 7 - s1.id > 3 and timestamp - s1.timestamp < 500",
    "name == s1.name or name == 'beta'",
    "(id + s1.id) * 3 != 12",
    "s1[last].price >= price",
    "id < 2.5 or id >= s1.price",
    "timestamp * 100000 > s1.timestamp * 100000",
    "price == s1.price or price != price",
    "(price < 50.0) == (s1.price < 50.0)",
    "timestamp - s1.timestamp <= 2 sec",
]


@pytest.mark.parametrize("expr", PROGRAMS)
def test_slot_program_equals_compile_expr(expr):
    """A cross filter's postfix program (what the slot scan runs, on the
    card and in the plain version) gives compile_expr's torch function
    on random columns: NaN, +-inf and int32 wrap included."""
    schema = fpt.StreamSchema(FIELDS)
    cql = (f"from every s1 = S[id > 0]+ -> s2 = S[{expr}] "
           "select s1.id as a insert into o")
    art = fpt.compile_plan(cql, {"S": schema}).artifacts[0]
    assert type(art).__name__ == "SlotNFAArtifact"
    spec = art.spec
    code = art.scan_plan.cross[1]
    assert code is not None and spec.cross_fns[1] is not None
    # compile_expr's function over the same resolver
    el = parse_plan(cql).queries[0].input.elements[1]
    resolver = nfa._ElemFilterResolver(
        1, el, schema, spec.elements, nfa.CaptureResolver(spec.elements,
                                                          {"S": schema}),
        [], {0: 0, 1: 1},
    )
    fn = compile_expr(el.filter, resolver).fn
    rng = np.random.default_rng(5)
    N = 4096

    def column(key):
        name = key.rsplit(".", 1)[-1]
        if name == "price":
            v = (rng.random(N) * 100).astype(np.float32)
            v[rng.random(N) < 0.05] = np.nan
            v[rng.random(N) < 0.05] = np.inf
            v[rng.random(N) < 0.05] = -np.inf
            return torch.from_numpy(v)
        if name == "timestamp":
            return torch.from_numpy(
                rng.integers(-2**31, 2**31, N).astype(np.int32))
        if name == "name":
            return torch.from_numpy(rng.integers(0, 3, N).astype(np.int32))
        return torch.from_numpy(rng.integers(-5, 6, N).astype(np.int32))

    env = {key: column(key) for key in art._cols}
    for e, c, w in spec.captures:
        env[nfa._cap_key(spec.elements[e].alias, w, c)] = column(c)

    def word(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    cols = [word(env[key]) for key in art._cols]
    caps = {}
    for e, c, w in spec.captures:
        pairs = nfa._cap_pairs(spec)
        P = len(pairs)
        if w.startswith("idx"):
            wd = 2 * P + art._idx.index((e, c, int(w[3:])))
        else:
            wd = 2 * pairs.index((e, c)) + (w == "last")
        caps[wd] = word(env[nfa._cap_key(spec.elements[e].alias, w, c)])
    got = eval_program(code, lambda c: cols[c], lambda w: caps[w])
    ref = fn(env)
    assert got.dtype == torch.int32
    assert torch.equal(got != 0, torch.broadcast_to(ref, (N,)))
    assert 0 < int((got != 0).sum()) or "!= price" in expr


@pytest.mark.parametrize("expr", [
    "math:abs(s1.price) > price",
    "id == 2 and math:sqrt(price - s1.price) > 2.0",
])
def test_cross_form_outside_the_program_raises_on_cpu(expr):
    # a function call over a capture (a registered function is a torch
    # function over a batch, not a per-slot program): the same refusal on
    # every device, at compile time, naming item 8. (`/` and `%` left this
    # list when the program gained them: tests/test_torch_slot_hoist.py)
    schema = fpt.StreamSchema(FIELDS)
    with pytest.raises(SiddhiQLError, match="slot program.*item 8"):
        fpt.compile_plan(
            f"from every s1 = S[id == 1] -> s2 = S[{expr}] "
            "select s1.id as a insert into o", {"S": schema},
        )


HEADLINE = (
    "from every s1 = inputStream[id == 1] -> s2 = inputStream[id == 2] -> "
    "s3 = inputStream[id == 3] within 5 sec "
    "select s1.timestamp as t1, s3.timestamp as t3, s3.price as price "
    "insert into matches"
)
BENCH_CONFIGS = {
    "headline": HEADLINE,
    "filter": "from inputStream[id == 2] select id, name, price "
              "insert into matches",
    "pattern2": "from every s1 = inputStream[id == 1] -> "
                "s2 = inputStream[id == 2] select s1.timestamp as t1, "
                "s2.timestamp as t2 insert into matches",
    "window_groupby": "from inputStream#window.length(1000) select id, "
                      "sum(price) as total, count() as cnt group by id "
                      "insert into matches",
    "multiquery64": "; ".join(
        f"from every s1 = inputStream[id == {q % 50}] -> "
        f"s2 = inputStream[id == {(q * 7 + 1) % 50}] "
        f"select s1.timestamp as t1, s2.timestamp as t2 insert into m{q}"
        for q in range(64)
    ),
}
_PORTED_ZOO = ["filter_select", "chain_pattern", "chain_pattern_within",
               "pattern_absence", "multiquery_stack6", "unique_window",
               "sort_window", "length_window_agg", "time_window_groupby",
               "timebatch_window", "expired_events", "slot_nfa_quantified",
               "sequence"]


@pytest.mark.parametrize("bench", [False, True], ids=["default", "bench"])
def test_artifact_classes_equal_the_reference(bench):
    """The bench configs and the ported zoo plans compile to the artifact
    classes the JAX package compiles them to, under the default settings
    and the bench's; the chain queries stay on the chain matcher."""
    cfg = dict(lazy_projection=True, pred_pushdown=True) if bench else {}
    plans = {f"bench_{k}": (v, "inputStream")
             for k, v in BENCH_CONFIGS.items()}
    plans.update({k: (PLAN_ZOO[k], "S") for k in _PORTED_ZOO})
    got = {}
    for name, (cql, sid) in plans.items():
        jplan = jax_compile(cql, {sid: JaxSchema(FIELDS)},
                            config=JaxConfig(**cfg))
        tplan = fpt.compile_plan(cql, {sid: fpt.StreamSchema(FIELDS)},
                                 config=EngineConfig(**cfg))
        classes = [type(a).__name__ for a in tplan.artifacts]
        assert classes == [type(a).__name__ for a in jplan.artifacts], name
        got[name] = classes
    assert got["bench_headline"] == ["ChainPatternArtifact"]
    assert got["bench_multiquery64"] == ["StackedChainArtifact"]
    assert got["slot_nfa_quantified"] == got["sequence"] == [
        "SlotNFAArtifact"]


SEGMENT_CQL = (
    "from every s1 = S[id == 1] -> s2 = S[id == 2]<2:3> -> s3 = S[id == 3] "
    "within 1 sec select s1.price as p1, s2[1].price as p2, "
    "s3.timestamp as t3 insert into o"
)


def _slot_job(data, batch, retain=True, fused=None):
    """The port's Job over ``data`` (one stream S) under the bench's
    settings, on the CPU."""
    schema = fpt.StreamSchema(FIELDS)
    cols = dict(data, name=data["name"].astype(np.int32))
    n = len(cols["timestamp"])
    batches = [
        fpt.EventBatch("S", schema, {k: v[s:s + batch]
                                     for k, v in cols.items()},
                       cols["timestamp"][s:s + batch])
        for s in range(0, n, batch)
    ]
    plan = fpt.compile_plan(
        SEGMENT_CQL, {"S": schema}, plan_id="p",
        config=EngineConfig(lazy_projection=True, pred_pushdown=True),
    )
    job = fpt.Job([plan], [fpt.BatchSource("S", schema, iter(batches))],
                  batch_size=batch, time_mode="processing",
                  retain_results=retain, device="cpu")
    if fused:
        job.fused_segment_len = fused
    return job


def test_slot_fused_rows_equal_streaming_and_jax():
    """The slot artifact in the fused streaming Job (each segment the body
    a CUDA graph captures on the card) gives the per-batch Job's rows,
    which are the JAX package's; resident replays of a slot plan are held
    in tests/test_torch_replay.py (``slot_nfa_quantified``)."""
    data = columns(5 * 4096, 30, seed=51, step_ms=1)
    ref, _ = run("jax", SEGMENT_CQL, {"S": data}, 4096, "o",
                 lazy_projection=True, pred_pushdown=True)
    stream = _slot_job(data, 4096)
    stream.run()
    assert stream.results_with_ts("o") == ref and len(ref) >= 50
    fused = _slot_job(data, 4096, fused=2)
    fused.run()
    assert fused.results_with_ts("o") == ref
    assert fused.eager_segments == 0 and fused.fusion_dispatches == 3


def test_slot_segment_body_makes_no_host_read(monkeypatch):
    """The slot step around the scan reads nothing on the host (what a
    CUDA graph could not capture): the segment body under the host-read
    guard, with the scan itself (on the card one kernel launch that reads
    its count on the device; here its plain version, which reads on the
    host) run with the guard paused and its outputs marked derived."""
    from test_torch_segments import HostReadGuard

    from flink_siddhi_tpu_torch.compiler import cuda_ops
    from flink_siddhi_tpu_torch.runtime.graphs import step_segment

    job = _slot_job(columns(3 * 4096, 30, seed=53, step_ms=1), 4096,
                    retain=False)
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
    # compacted: the relevant index and its count, left on the device
    assert calls[0][-2] is not None and tuple(calls[0][-1].shape) == (1,)
    assert int(acc["meta"][0].sum()) > 0
