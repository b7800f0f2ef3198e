"""Multi-query stacking in the torch port against the JAX package.

Structurally identical chain queries (one pattern shape, pool and output
types) compile into one ``StackedChainArtifact``: their predicates,
captures and projections stacked as data on a leading query axis, the
chain core run once for all of them (the reference runs it under
``jax.vmap``), and one packed emission block whose query-id row routes
each row to its member's output stream.

Each test makes its stream with numpy from a seed, runs the same
SiddhiQL in both packages (the port on the CPU, its kernels through their
plain versions; the JAX package on its CPU path) and requires the same
rows, timestamps and order in every output stream. Covered: the bench's
``multiquery64`` and the zoo's ``multiquery_stack6`` under the default
and the bench's ``EngineConfig``; the relevance-compacted branch and the
full-width one; the members' closure predicates and mixed operators;
``within`` per member; non-``every`` members; the emission buffer's
overflow count; the compile-window cap and chunked stepping; a reference
snapshot restored mid-stream; the host-known relevance bound; terminal
timed absence against a brute-force oracle; and the chain advance's
plain version with a query axis.
"""

import jax
import numpy as np
import pytest
import torch

import bench
from flink_siddhi_tpu.analysis.zoo import PLAN_ZOO
from flink_siddhi_tpu.compiler import pallas_ops
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.tape import build_tape as jax_build_tape
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler import cuda_ops, nfa
from flink_siddhi_tpu_torch.compiler.plan import state_to_numpy
from flink_siddhi_tpu_torch.runtime.tape import build_tape as torch_build_tape

from test_torch_slice import _FIELDS, _columns, _run

torch.set_num_threads(2)

BENCH = dict(lazy_projection=True, pred_pushdown=True)
CONFIGS = {"default": {}, "bench": BENCH}
MQ64 = bench._config_cql("multiquery64")


def _stack(members, every=True, within=None):
    """A plan of ``every s1 = inputStream[f1] -> s2 = inputStream[f2]``
    queries, one per (f1, f2), each into its own stream m<q>."""
    w = f" within {within} milliseconds" if within else ""
    return "; ".join(
        f"from {'every ' if every else ''}s1 = inputStream[{f1}] -> "
        f"s2 = inputStream[{f2}]{w} "
        f"select s1.timestamp as t1, s2.price as p2 insert into m{q}"
        for q, (f1, f2) in enumerate(members)
    )


def _assert_streams(cql, data, batch, outs, min_rows=1, **config):
    """Both packages over ``data``; every stream of ``outs`` equal.
    Returns (total rows, the JAX job, the port's job)."""
    _, jjob = _run("jax", cql, data, batch, **config)
    _, tjob = _run("torch", cql, data, batch, **config)
    total = 0
    for out in outs:
        ref = jjob.results_with_ts(out)
        assert tjob.results_with_ts(out) == ref, out
        total += len(ref)
    assert total >= min_rows, "the stream produced too few rows"
    return total, jjob, tjob


def _stacked(job):
    (art,) = job._plans["p"].plan.artifacts
    assert isinstance(art, nfa.StackedChainArtifact)
    return art


@pytest.fixture
def advance_widths(monkeypatch):
    """(Q, V) of every chain-advance call."""
    shapes = []
    real = nfa.chain_advance

    def rec(nxt, pos_rows, guard_rows, ts_pad, act, *rest):
        shapes.append(tuple(act.shape))
        return real(nxt, pos_rows, guard_rows, ts_pad, act, *rest)

    monkeypatch.setattr(nfa, "chain_advance", rec)
    return shapes


# --------------------------------------------------------------------------
# The bench's multiquery64 and the zoo's multiquery_stack6
# --------------------------------------------------------------------------

@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_multiquery64_matches_jax_per_stream(config, advance_widths):
    data = _columns(4 * 8192, 8192, 50, seed=3)
    _, _, tjob = _assert_streams(MQ64, data, 8192,
                                 [f"m{q}" for q in range(64)],
                                 min_rows=20_000, **CONFIGS[config])
    art = _stacked(tjob)
    assert len(art.members) == 64 and art.name == "@stack:query_0"
    plan = tjob._plans["p"].plan
    assert plan.tape_capacity_limit == 131072
    # a stack gets no pushdown and no lazy projection: id and timestamp
    # travel to the device
    assert plan.spec.host_preds == ()
    assert plan.spec.device_columns is None
    # the host-known bound is under E // 16: every step compacts with no
    # read, one chain advance for all 64 members
    assert art.host_syncs == 0 and tjob.host_syncs == tjob.drain_syncs
    Rw = nfa._stack_compact_width(8192)
    assert advance_widths == [(64, 1024 + Rw)] * len(data)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_multiquery_stack6_matches_jax_per_stream(config):
    data = _columns(2 * 8192, 8192, 10, seed=3,
                    names=("alpha", "beta", "gamma"))
    _, _, tjob = _run_stack6(data, **CONFIGS[config])
    art = _stacked(tjob)
    assert len(art.members) == 6 and art._vec_info is not None
    assert tjob._plans["p"].plan.tape_capacity_limit is None


def _run_stack6(data, batch=8192, **config):
    kw = dict(stream="S", names=("alpha", "beta", "gamma"))
    _, jjob = _run("jax", PLAN_ZOO["multiquery_stack6"], data, batch,
                   **kw, **config)
    _, tjob = _run("torch", PLAN_ZOO["multiquery_stack6"], data, batch,
                   **kw, **config)
    total = 0
    for i in range(6):
        ref = jjob.results_with_ts(f"out{i}")
        assert len(ref) > 100
        assert tjob.results_with_ts(f"out{i}") == ref
        total += len(ref)
    return total, jjob, tjob


def test_member_stream_through_the_api():
    # the fluent API names any member's stream, not only the first's
    rows = fpt.SiddhiCEP.define(
        "S", [(i % 4, 1000 + i) for i in range(40)], ["id", "timestamp"],
        device="cpu",
    ).cql(
        "from every a = S[id == 1] -> b = S[id == 2] "
        "select a.timestamp as t1, b.timestamp as t2 insert into o0; "
        "from every a = S[id == 2] -> b = S[id == 3] "
        "select a.timestamp as t1, b.timestamp as t2 insert into o1"
    ).return_as_map("o1")
    assert rows[0] == {"t1": 1002, "t2": 1003} and len(rows) == 10


# --------------------------------------------------------------------------
# Branches and predicate forms
# --------------------------------------------------------------------------

def test_dense_stream_takes_full_width_branch(advance_widths):
    # ids in [0, 3): each member's relevant events exceed E // 16, so the
    # host bound reads the device count once a batch and the full-width
    # core runs
    members = [("id == 0", "id == 1"), ("id == 1", "id == 2"),
               ("id == 2", "id == 0")]
    data = _columns(3 * 8192, 8192, 3, seed=11)
    _, _, tjob = _assert_streams(_stack(members), data, 8192,
                                 ["m0", "m1", "m2"], min_rows=10_000)
    art = _stacked(tjob)
    assert art.host_syncs == len(data)
    assert advance_widths == [(3, 1024 + 8192)] * len(data)


@pytest.mark.parametrize("members,vectorized", [
    # an 'or' does not flatten into conjuncts: each member's own closure
    ([("id == 1 or id == 2", "id == 3"), ("id == 4 or id == 5", "id == 6"),
      ("id == 7 or id == 8", "id == 9")], False),
    # one conjunct key per element, other operators per member: the
    # broadcast compares select each member's operator
    ([("id < 3", "id >= 47"), ("id >= 46", "id != 20"),
      ("id != 30", "id < 2"), ("id > 48", "id <= 1")], True),
], ids=["closure_fallback", "mixed_operators"])
def test_predicate_forms_match_jax(members, vectorized):
    data = _columns(3 * 8192, 8192, 50, seed=5)
    _, _, tjob = _assert_streams(
        _stack(members), data, 8192, [f"m{q}" for q in range(len(members))],
        min_rows=1000,
    )
    assert (_stacked(tjob)._vec_info is not None) == vectorized


def test_within_per_member_matches_jax():
    members = [("id == 1", "id == 2"), ("id == 3", "id == 4"),
               ("id == 5", "id == 6")]
    windows = (20, 80, 300)
    cql = "; ".join(
        f"from every s1 = inputStream[{f1}] -> s2 = inputStream[{f2}] "
        f"within {w} milliseconds select s1.timestamp as t1, "
        f"s2.price as p2 insert into m{q}"
        for q, ((f1, f2), w) in enumerate(zip(members, windows))
    )
    data = _columns(3 * 8192, 8192, 40, seed=7)
    _, jjob, tjob = _assert_streams(cql, data, 8192, ["m0", "m1", "m2"],
                                    min_rows=300)
    counts = [len(tjob.results_with_ts(f"m{q}")) for q in range(3)]
    assert counts[0] < counts[1] < counts[2]  # the windows differ
    assert len(_stacked(tjob).members) == 3


def test_non_every_members_match_jax():
    members = [("id == 1", "id == 2"), ("id == 5", "id == 3"),
               ("id == 7", "id == 7")]
    data = _columns(3 * 8192, 8192, 60, seed=13)
    _assert_streams(_stack(members, every=False), data, 8192,
                    ["m0", "m1", "m2"], min_rows=3)


# --------------------------------------------------------------------------
# The emission buffer's overflow count (the accumulator's third element)
# --------------------------------------------------------------------------

def _step_plans(cql, data, **config):
    """Both plans stepped by hand over ``data``, one fresh accumulator a
    step; per step the accumulator's meta and every stream's rows."""
    jplan = jax_compile(cql, {"inputStream": JaxSchema(_FIELDS)},
                        config=_jax_config(**config))
    tplan = fpt.compile_plan(cql, {"inputStream": fpt.StreamSchema(_FIELDS)},
                             config=fpt.EngineConfig(**config))

    def batch(Schema, Batch, d):
        return Batch("inputStream", Schema(_FIELDS),
                     {"id": d["id"], "name": d["name"].astype(np.int32),
                      "price": d["price"], "timestamp": d["ts"]}, d["ts"])

    def rows(plan, meta, buf):
        counts = np.asarray(meta)[0]
        n = int(counts.max())
        out = {}
        decoded = plan.drain_decode(counts, np.asarray(buf)[:, :n])
        for parts in decoded.values():
            for schema, r in parts:
                out[schema.stream_id] = r
        return out

    jstep = jax.jit(jplan.step_acc)
    jst, tst = jplan.init_state(), tplan.init_state("cpu")
    steps = []
    for d in data:
        jt, _ = jax_build_tape(jplan.spec, [batch(JaxSchema, JaxBatch, d)],
                               1000)
        tt = torch_build_tape(
            tplan.spec, [batch(fpt.StreamSchema, fpt.EventBatch, d)], 1000
        ).to(torch.device("cpu"))
        jst, jacc = jstep(jst, jplan.init_acc(), jt)
        tst, tacc = tplan.step_acc(tst, tplan.init_acc("cpu"), tt)
        steps.append((
            (np.asarray(jacc["meta"]), rows(jplan, jacc["meta"], jacc["buf"])),
            (tacc["meta"].numpy(), rows(tplan, tacc["meta"].numpy(),
                                        tacc["buf"].numpy())),
        ))
    return steps, jst, tst, tplan


def _jax_config(**config):
    from flink_siddhi_tpu.compiler.config import EngineConfig

    return EngineConfig(**config)


def test_emission_overflow_matches_jax():
    # twelve members that each complete at almost every event: twelve
    # times E completions a step against a block of 8 E + 12 P
    members = [(f"id != {100 + q}", f"id != {200 + q}") for q in range(12)]
    data = _columns(2 * 4096, 4096, 50, seed=17)
    steps, _, _, tplan = _step_plans(_stack(members), data)
    art = tplan.artifacts[0]
    width = art.emit_block_width(4096, None)
    assert width == 8 * 4096 + 12 * 1024
    for (jmeta, jrows), (tmeta, trows) in steps:
        assert np.array_equal(jmeta, tmeta)
        assert tmeta[0, 0] == width and tmeta[1, 0] > 1000
        assert trows == jrows


# --------------------------------------------------------------------------
# The compile-window cap and chunked stepping
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_queries", [15, 16])
def test_tape_capacity_limit_matches_jax(n_queries):
    cql = _stack([(f"id == {q}", f"id == {q + 1}")
                  for q in range(n_queries)])
    jplan = jax_compile(cql, {"inputStream": JaxSchema(_FIELDS)})
    tplan = fpt.compile_plan(cql, {"inputStream": fpt.StreamSchema(_FIELDS)})
    assert tplan.tape_capacity_limit == jplan.tape_capacity_limit
    assert tplan.tape_capacity_limit == (131072 if n_queries >= 16
                                         else None)
    capped = fpt.compile_plan(cql, {"inputStream": fpt.StreamSchema(_FIELDS)},
                              config=fpt.EngineConfig(max_tape_capacity=4096))
    assert capped.tape_capacity_limit == 4096


def test_chunked_stepping_matches_jax(advance_widths):
    # a 4,096-event window under batch 8,192: each batch steps in two
    # chunks, in both packages
    data = _columns(2 * 8192, 8192, 10, seed=3,
                    names=("alpha", "beta", "gamma"))
    _run_stack6(data, max_tape_capacity=4096)
    assert len(advance_widths) == 2 * len(data)
    assert {v for _, v in advance_widths} == {1024 + 2048}


# --------------------------------------------------------------------------
# State carried across packages, the host bound
# --------------------------------------------------------------------------

def test_reference_snapshot_restored_mid_stream():
    """The JAX stack steps batch 1; its state, fetched as numpy, seeds the
    port's stack; both step batch 2 from the same carried partials."""
    members = [(f"id == {q}", f"id == {q + 3}") for q in range(5)]
    cql = _stack(members, within=400)
    data = _columns(2 * 8192, 8192, 20, seed=21)
    jplan = jax_compile(cql, {"inputStream": JaxSchema(_FIELDS)})
    tplan = fpt.compile_plan(cql, {"inputStream": fpt.StreamSchema(_FIELDS)})
    (jart,), (tart,) = jplan.artifacts, tplan.artifacts
    assert tart.name == jart.name

    def batch(Schema, Batch, d):
        return Batch("inputStream", Schema(_FIELDS),
                     {"id": d["id"], "name": d["name"].astype(np.int32),
                      "price": d["price"], "timestamp": d["ts"]}, d["ts"])

    jstep = jax.jit(jplan.step_acc)
    jt1, _ = jax_build_tape(jplan.spec, [batch(JaxSchema, JaxBatch, data[0])],
                            1000)
    jst, _ = jstep(jplan.init_state(), jplan.init_acc(), jt1)
    carried = jax.device_get(jst)
    assert carried[jart.name]["active"].any()
    tst = fpt.state_from_numpy(tplan, carried, "cpu")
    jt2, _ = jax_build_tape(jplan.spec, [batch(JaxSchema, JaxBatch, data[1])],
                            1000)
    tt2 = torch_build_tape(
        tplan.spec, [batch(fpt.StreamSchema, fpt.EventBatch, data[1])], 1000
    ).to(torch.device("cpu"))
    jst2, jacc = jstep(jst, jplan.init_acc(), jt2)
    tst2, tacc = tplan.step_acc(tst, tplan.init_acc("cpu"), tt2)
    for acc in (jacc, tacc):
        acc["meta"] = np.asarray(acc["meta"])
        acc["buf"] = np.asarray(acc["buf"])
    n = int(jacc["meta"][0].max())
    assert n > 100 and np.array_equal(jacc["meta"], tacc["meta"])
    jrows = jplan.drain_decode(jacc["meta"][0], jacc["buf"][:, :n])
    trows = tplan.drain_decode(tacc["meta"][0], tacc["buf"][:, :n])
    assert [(sch.stream_id, r) for sch, r in trows[tart.name]] == \
        [(sch.stream_id, r) for sch, r in jrows[jart.name]]
    jfinal = jax.device_get(jst2)[jart.name]
    tfinal = state_to_numpy(tst2)[tart.name]
    assert set(jfinal) == set(tfinal)
    for k in jfinal:
        assert np.array_equal(np.asarray(jfinal[k]), tfinal[k]), k


def test_host_bound_covers_each_member():
    # the tape's bound is the largest member's sum of its literals'
    # counts, at least each member's true relevant count
    plan = fpt.compile_plan(MQ64, {"inputStream": fpt.StreamSchema(_FIELDS)},
                            config=fpt.EngineConfig(**BENCH))
    (art,) = plan.artifacts
    d = _columns(8192, 8192, 50, seed=3)[0]
    schema = fpt.StreamSchema(_FIELDS)
    tape = torch_build_tape(plan.spec, [fpt.EventBatch(
        "inputStream", schema,
        {"id": d["id"], "name": d["name"].astype(np.int32),
         "price": d["price"], "timestamp": d["ts"]}, d["ts"],
    )], 1000)
    counts = np.bincount(d["id"], minlength=50)
    expect = max(counts[q % 50] + counts[(7 * q + 1) % 50]
                 for q in range(64))
    assert tape.bounds == {art.name: int(expect)}
    assert expect <= nfa._stack_compact_width(8192)


def test_timed_absence_stack_matches_oracle():
    """Terminal timed absence per member, pending deadlines emitted by the
    end-of-stream flush. At batch 2,048 (the full-width branch) the port
    equals the JAX package; at batch 8,192 (the compacted branch) it
    equals a brute-force oracle (the JAX package's compacted branch
    searches an unsorted padded tail: ROADMAP.md Queue 3)."""
    triggers, guards = (1, 4, 6), (9, 8, 7)
    cql = "; ".join(
        f"from every s1 = inputStream[id == {a}] -> "
        f"not inputStream[id == {g}] for 40 milliseconds "
        f"select s1.timestamp as t1, s1.price as p insert into m{q}"
        for q, (a, g) in enumerate(zip(triggers, guards))
    )
    data = _columns(3 * 8192, 8192, 60, seed=13)
    flat = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    small = [{k: v[i:i + 2048] for k, v in flat.items()}
             for i in range(0, len(flat["id"]), 2048)]
    outs = ["m0", "m1", "m2"]
    _assert_streams(cql, small, 2048, outs, min_rows=300)
    _, tjob = _run("torch", cql, data, 8192)
    assert len(_stacked(tjob).members) == 3
    for q, (a, g) in enumerate(zip(triggers, guards)):
        gts = flat["ts"][flat["id"] == g]
        oracle = [
            (int(t) + 40, (int(t), float(np.float32(p))))
            for t, p in zip(flat["ts"][flat["id"] == a],
                            flat["price"][flat["id"] == a])
            if not np.any((gts > t) & (gts <= t + 40))
        ]
        assert len(oracle) > 100
        assert tjob.results_with_ts(f"m{q}") == oracle


# --------------------------------------------------------------------------
# The chain advance and the compaction with a query axis
# --------------------------------------------------------------------------

def _advance_inputs(rng, Q, E, P, n_rows):
    V = P + E
    tables = []
    for _ in range(Q * n_rows):
        idx = np.where(rng.random(E) < 0.08, np.arange(E), E).astype(np.int32)
        row = np.full(E + 1, E, np.int32)
        row[:E] = np.minimum.accumulate(idx[::-1])[::-1]
        tables.append(row)
    tsp = np.concatenate(
        [np.sort(rng.integers(0, 1 << 13, (Q, E)), 1),
         np.zeros((Q, 1), np.int64)], 1,
    ).astype(np.int32)
    act = rng.random((Q, V)) < 0.6
    step = rng.integers(1, 3, (Q, V)).astype(np.int32)
    pos = rng.integers(0, E + 1, (Q, V)).astype(np.int32)
    start = rng.integers(0, 1 << 13, (Q, V)).astype(np.int32)
    return np.stack(tables), tsp, act, step, pos, start


@pytest.mark.parametrize("Q", [1, 5])
def test_batched_chain_advance_plain(Q):
    # rows per query: step 1's table, step 2's, one guard of step 2
    rng = np.random.default_rng(40 + Q)
    E, P = 700, 32
    table, tsp, act, step, pos, start = _advance_inputs(rng, Q, E, P, 3)
    within = np.asarray([300 + 97 * q for q in range(Q)], np.int32)
    got = cuda_ops.chain_advance(
        torch.from_numpy(table), [0, 1], [[], [2]], torch.from_numpy(tsp),
        torch.from_numpy(act), torch.from_numpy(step),
        torch.from_numpy(pos), torch.from_numpy(start),
        torch.from_numpy(within),
    )
    for q in range(Q):
        # each query alone: the single-query call, and the numpy oracle
        one = cuda_ops.chain_advance(
            torch.from_numpy(table[3 * q:3 * q + 3]), [0, 1], [[], [2]],
            torch.from_numpy(tsp[q]), torch.from_numpy(act[q]),
            torch.from_numpy(step[q]), torch.from_numpy(pos[q]),
            torch.from_numpy(start[q]), int(within[q]),
        )
        ref = pallas_ops._ref_chain_advance(
            (0, 1, 2), ((), (), (3,)), True,
            {1: table[3 * q], 2: table[3 * q + 1], 3: table[3 * q + 2]},
            tsp[q], act[q], step[q], pos[q], start[q], within[q],
        )
        for g, o, r in zip(got, one, ref):
            assert np.array_equal(g[q].numpy(), o.numpy())
            assert np.array_equal(o.numpy(), np.asarray(r))
    assert got[3].shape == (Q, 2, P + E)
    assert cuda_ops.launch_counts()["chain_advance"] == 0


def test_batched_compaction_matches_per_query():
    rng = np.random.default_rng(3)
    rel = torch.from_numpy(rng.random((4, 5000)) < np.array(
        [[0.01], [0.3], [0.45], [0.0]]))
    idx, cnt, cvalid = nfa._compact_index(rel, 2048)
    assert idx.shape == cvalid.shape == (4, 2048)
    for q in range(4):
        i1, c1, v1 = nfa._compact_index(rel[q], 2048)
        want = np.flatnonzero(rel[q].numpy())
        assert int(cnt[q]) == int(c1) == len(want)
        assert torch.equal(cvalid[q], v1)
        n = min(int(c1), 2048)
        assert int(v1.sum()) == n
        assert torch.equal(idx[q, :n], i1[:n])
        assert np.array_equal(i1[:n].numpy(), want[:n])
