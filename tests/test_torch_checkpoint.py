"""Checkpoint / restore of the torch port (``runtime/checkpoint.py``), held
against the JAX package on the CPU.

* ``tests/test_checkpoint.py`` through the port: run-half + restore equals
  the full run (window rings, group tables and their encoders, string
  dictionaries, partial pattern matches, batch windows, event tables), a
  file and a path-like, and the three rejections (a changed plan, a
  changed window size, another time mode).
* ``tests/test_lazy_projection.py``'s two restore tests: after a restore
  the lazy ring re-syncs from the restored device ordinal counter, so new
  matches decode real values.
* Files across packages: a JAX ``Job`` saved mid-stream restores into the
  port, and the rows that follow equal those of a JAX ``Job`` restored
  from the same file; then the other way round. The headline chain (also
  under the bench's lazy projection and pushdown), the slot NFA, a
  group-by window, a join, a table and a session window.
* The control plane's blocks (``dynamic``: the dynamically added queries
  and their group slots and enable flags; ``control_pending``: the control
  events still behind the watermark) in files moved both ways.
* The blocks of modules the port does not have yet refuse to restore,
  naming their ROADMAP item; saving keeps K generations.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flink_siddhi_tpu.compiler.config import EngineConfig as JaxConfig
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.sources import (
    ReplayBatchSource as JaxReplaySource,
)
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch import CEPEnvironment, SiddhiCEP
from flink_siddhi_tpu_torch.compiler.config import EngineConfig
from flink_siddhi_tpu_torch.runtime import checkpoint as ckpt_mod
from flink_siddhi_tpu_torch.runtime.sources import (
    BatchSource,
    ReplayBatchSource,
)

torch.set_num_threads(2)


@dataclasses.dataclass
class Event:
    id: int
    name: str
    price: float
    timestamp: int


FIELDS = ["id", "name", "price", "timestamp"]


def make_events(n, start_ts=1000):
    return [
        Event(i % 4, f"name_{i % 3}", float(i), start_ts + 1000 * i)
        for i in range(n)
    ]


def _env(**kw):
    return CEPEnvironment(batch_size=5, device="cpu", **kw)


def run_full(events, cql, out="out"):
    return SiddhiCEP.define("S", events, FIELDS, env=_env()).cql(cql) \
        .returns(out)


def run_split(events, cql, k, out="out"):
    """The first k events, a snapshot, then a fresh environment over the
    whole stream whose restored source position skips the prefix."""
    job1 = SiddhiCEP.define("S", events[:k], FIELDS, env=_env()).cql(cql) \
        .execute()
    snap = job1.snapshot()
    job2 = SiddhiCEP.define("S", events, FIELDS, env=_env()).cql(cql).job
    job2.restore(snap)
    job2.run()
    return job1.results(out) + job2.results(out)


CASES = [
    "from S#window.length(6) select sum(price) as t, min(price) as lo "
    "insert into out",
    "from S select id, sum(price) as t, count() as c group by id "
    "insert into out",
    "from S select name, count() as c group by name insert into out",
    "from every s1 = S[id == 2] -> s2 = S[id == 3] "
    "select s1.price as p1, s2.price as p2 insert into out",
    "from S#window.lengthBatch(7) select sum(price) as t insert into out",
]


@pytest.mark.parametrize("cql", CASES)
@pytest.mark.parametrize("k", [9, 13])
def test_restore_equivalence(cql, k):
    events = make_events(30)
    assert run_split(events, cql, k) == run_full(events, cql)


def test_restore_event_table():
    events = make_events(20)
    cql = (
        "define table T (tid int, total double);"
        "from S[id == 0] select id as tid, price as total insert into T;"
        "from S[id == 1] join T on S.id == T.tid + 1 "
        "select S.price, T.total insert into out"
    )
    assert run_split(events, cql, 11) == run_full(events, cql)


def test_save_load_file(tmp_path):
    events = make_events(24)
    cql = "from S#window.length(5) select sum(price) as t insert into out"
    job1 = SiddhiCEP.define("S", events[:12], FIELDS, env=_env()).cql(cql) \
        .execute()
    path = str(tmp_path / "ckpt.bin")
    job1.save_checkpoint(path)
    job2 = SiddhiCEP.define("S", events, FIELDS, env=_env()).cql(cql).job
    job2.restore(path)
    job2.run()
    assert job1.results("out") + job2.results("out") == run_full(events, cql)


def test_restore_rejects_changed_plan():
    events = make_events(10)
    job1 = SiddhiCEP.define("S", events, FIELDS, env=_env()).cql(
        "from S#window.length(5) select sum(price) as t insert into out"
    ).execute()
    snap = job1.snapshot()
    es2 = SiddhiCEP.define("S", events, FIELDS, env=_env()).cql(
        "from every s1 = S[id == 2] -> s2 = S[id == 3] "
        "select s1.price as p insert into out"
    )
    with pytest.raises(ValueError):
        es2.job.restore(snap)


def test_restore_rejects_changed_window_size():
    events = make_events(12)
    job1 = SiddhiCEP.define("S", events, FIELDS, env=_env()).cql(
        "from S#window.length(5) select sum(price) as t insert into out"
    ).execute()
    snap = job1.snapshot()
    es2 = SiddhiCEP.define("S", events, FIELDS, env=_env()).cql(
        "from S#window.length(9) select sum(price) as t insert into out"
    )
    with pytest.raises(ValueError, match="shape|dtype|CQL"):
        es2.job.restore(snap)


def test_restore_rejects_time_mode_mismatch():
    events = make_events(12)
    cql = "from S select id, price insert into out"
    job1 = SiddhiCEP.define("S", events, FIELDS, env=_env()).cql(cql) \
        .execute()
    snap = job1.snapshot()
    es2 = SiddhiCEP.define("S", events, FIELDS,
                           env=_env(time_mode="processing")).cql(cql)
    with pytest.raises(ValueError, match="time mode"):
        es2.job.restore(snap)


def test_restore_accepts_pathlike(tmp_path):
    events = make_events(12)
    cql = "from S#window.length(5) select sum(price) as t insert into out"
    job1 = SiddhiCEP.define("S", events, FIELDS, env=_env()).cql(cql) \
        .execute()
    path = tmp_path / "ckpt.bin"
    job1.save_checkpoint(str(path))
    es2 = SiddhiCEP.define("S", events, FIELDS, env=_env()).cql(cql)
    es2.job.restore(path)


def test_keep_rotates_generations_and_sweeps_temp_files(tmp_path):
    events = make_events(12)
    cql = "from S#window.length(5) select sum(price) as t insert into out"
    job = SiddhiCEP.define("S", events, FIELDS, env=_env()).cql(cql).job
    path = str(tmp_path / "ck")
    (tmp_path / "ck.tmp.424242").write_bytes(b"debris")
    for _ in range(3):
        job.run(max_cycles=1)
        job.save_checkpoint(path, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck", "ck.1"]
    assert ckpt_mod.checkpoint_generations(path, 3) == [
        path, f"{path}.1", f"{path}.2"]


@pytest.mark.parametrize("block,value,item", [
    ("routers", {"p": {}}, 11),
    ("fleet", {"epoch": 3, "last_handoff": None}, 13),
])
def test_later_blocks_refuse_naming_their_item(block, value, item):
    events = make_events(10)
    cql = "from S#window.length(5) select sum(price) as t insert into out"
    snap = SiddhiCEP.define("S", events, FIELDS, env=_env()).cql(cql) \
        .execute().snapshot()
    snap[block] = value
    job = SiddhiCEP.define("S", events, FIELDS, env=_env()).cql(cql).job
    with pytest.raises(ValueError, match=f"item {item}\\b"):
        job.restore(snap)


# -- lazy projection across a restore (tests/test_lazy_projection.py) -------

SCHEMA_FIELDS = [("id", "int"), ("name", "string"), ("price", "double"),
                 ("timestamp", "long")]
LAZY_CQL = (
    "from every s1 = S[id == 1] -> s2 = S[id == 2] -> s3 = S[id == 3] "
    "within 5 sec "
    "select s1.timestamp as t1, s3.timestamp as t3, s3.price as price, "
    "s3.name as n3 insert into matches"
)
SELECT_CQL = "from S[id == 2] select id, name, price insert into out"


def make_batches(schema, batch_cls, n=2000, batch=64, seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 6, n).astype(np.int32)
    prices = np.round(rng.random(n) * 100, 3)
    names = rng.integers(0, 3, n)
    ts = (1000 + np.arange(n)).astype(np.int64)
    tbl = schema.string_tables["name"]
    codes = np.array([tbl.intern(f"nm{i}") for i in range(3)], np.int32)
    return [
        batch_cls(
            "S", schema,
            {"id": ids[s:s + batch], "name": codes[names[s:s + batch]],
             "price": prices[s:s + batch], "timestamp": ts[s:s + batch]},
            ts[s:s + batch],
        )
        for s in range(0, n, batch)
    ]


def _lazy_job(cql, batches, schema):
    plan = fpt.compile_plan(cql, {"S": schema},
                            config=EngineConfig(lazy_projection=True))
    return fpt.Job([plan], [BatchSource("S", schema, iter(batches))],
                   batch_size=64, time_mode="processing", device="cpu")


def test_lazy_survives_checkpoint_restore(tmp_path):
    schema = fpt.StreamSchema(SCHEMA_FIELDS)
    batches = make_batches(schema, fpt.EventBatch, n=512, batch=64)
    job = _lazy_job(LAZY_CQL, batches[:4], schema)
    job.run(max_cycles=4)
    p = tmp_path / "c.bin"
    job.save_checkpoint(str(p))
    job2 = _lazy_job(LAZY_CQL, batches[4:], schema)
    job2.restore(str(p))
    rt = job2._plans["plan"]
    assert rt.lazy_base == 4 * 64  # the restored device ordinal counter
    job2.run()
    rows = job2.results("matches")
    post = [r for r in rows if r[2] is not None]
    # new matches carry real values (only partials carried across the
    # restore may decode None)
    assert post, f"all post-restore matches decoded None: {rows[:5]}"


def test_lazy_select_survives_checkpoint_restore(tmp_path):
    schema = fpt.StreamSchema(SCHEMA_FIELDS)
    batches = make_batches(schema, fpt.EventBatch, n=512, batch=64)
    job = _lazy_job(SELECT_CQL, batches[:4], schema)
    job.run()
    path = str(tmp_path / "ck")
    job.save_checkpoint(path)
    job2 = _lazy_job(SELECT_CQL, batches[4:], schema)
    job2.restore(path)
    job2.run()
    rows = job2.results("out")
    assert rows
    for row in rows:
        assert row[1] is not None and row[2] is not None


# -- checkpoint files across packages ---------------------------------------

PKGS = {
    "jax": (JaxSchema, JaxBatch, JaxReplaySource, jax_compile, JaxJob,
            JaxConfig, {}),
    "torch": (fpt.StreamSchema, fpt.EventBatch, ReplayBatchSource,
              fpt.compile_plan, fpt.Job, EngineConfig, {"device": "cpu"}),
}
NAMES = ("alpha", "beta", "gamma")


def _columns(n, n_ids, seed, step_ms=7, t0=1000, offset=0):
    """A seeded stream: integer-valued prices (window sums stay exact in
    float32 in both packages)."""
    rng = np.random.default_rng(seed)
    return {
        "id": rng.integers(0, n_ids, n).astype(np.int32),
        "name": rng.integers(0, len(NAMES), n),
        "price": rng.integers(0, 100, n).astype(np.float64),
        "timestamp": t0 + offset + step_ms * np.arange(n, dtype=np.int64),
    }


def _build(pkg, cql, streams, batch, config, control=True):
    """A job over seeded streams: one static plan of ``cql``, or, with
    ``share_subplans`` in ``config``, its queries admitted as tenants
    through control events at ts 0 with subplan sharing on (``control``
    False: no control source, for a job a checkpoint restores into)."""
    Schema, Batch, Source, compile_plan, Job, Config, kw = PKGS[pkg]
    config = dict(config)
    share = config.pop("share_subplans", False)
    schemas, sources = {}, []
    strings = None
    for sid, cols in streams.items():
        schema = (Schema(SCHEMA_FIELDS) if strings is None
                  else Schema(SCHEMA_FIELDS, shared_strings=strings))
        strings = schema.string_tables["name"]
        schemas[sid] = schema
        data = dict(cols)
        codes = np.array([strings.intern(n) for n in NAMES], np.int32)
        data["name"] = codes[data["name"]]
        n = len(data["timestamp"])
        batches = [
            Batch(sid, schema, {k: v[s:s + batch] for k, v in data.items()},
                  data["timestamp"][s:s + batch])
            for s in range(0, n, batch)
        ]
        sources.append(Source(sid, schema, batches))
    if share:
        return _tenant_job(pkg, cql, schemas, sources, batch, control)
    plan = compile_plan(cql, schemas, plan_id="p", config=Config(**config))
    return Job([plan], sources, batch_size=batch, time_mode="event", **kw)


def _tenant_job(pkg, cql, schemas, sources, batch, control):
    _, _, _, compile_plan, Job, _, kw = PKGS[pkg]
    if pkg == "torch":
        from flink_siddhi_tpu_torch.control import events as ev
        from flink_siddhi_tpu_torch.runtime.sources import ControlListSource
    else:
        from flink_siddhi_tpu.control import events as ev
        from flink_siddhi_tpu.runtime.sources import ControlListSource
    timeline = []
    for i, q in enumerate(cql.split(";")):
        b = ev.MetadataControlEvent.builder()
        b.add_execution_plan(q.strip(), plan_id=f"t{i}")
        add = b.build()
        add.tenant = f"tenant{i}"
        timeline.append((0, add))
    job = Job([], sources, batch_size=batch, time_mode="event",
              control_sources=([ControlListSource(timeline)]
                               if control else []),
              plan_compiler=lambda q, pid: compile_plan(q, schemas,
                                                        plan_id=pid),
              **kw)
    job.share_subplans = True
    return job


def _same_rows(got, ref, what):
    assert len(got) == len(ref), what
    for (tg, rg), (tr, rr) in zip(got, ref):
        assert tg == tr and len(rg) == len(rr), (what, rg, rr)
        for a, b in zip(rg, rr):
            if isinstance(a, float) and isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-6), (what, rg, rr)
            else:
                assert a == b, (what, rg, rr)


CROSS = {
    "headline": (
        "from every s1 = S[id == 1] -> s2 = S[id == 2] -> s3 = S[id == 3] "
        "within 5 sec select s1.timestamp as t1, s3.timestamp as t3, "
        "s3.price as price insert into o", {"S": (6, 1)}, {}),
    "headline_bench_settings": (
        "from every s1 = S[id == 1] -> s2 = S[id == 2] -> s3 = S[id == 3] "
        "within 5 sec select s1.timestamp as t1, s3.timestamp as t3, "
        "s3.price as price insert into o", {"S": (6, 1)},
        {"lazy_projection": True, "pred_pushdown": True}),
    "slot_nfa": (
        "from every s1 = S[id == 2]<2:2> -> s2 = S[id == 3] "
        "select s1[0].timestamp as t1, s1[last].timestamp as t2, "
        "s2.price as p insert into o", {"S": (5, 2)}, {}),
    "group_by_window": (
        "from S#window.length(50) select id, name, sum(price) as total, "
        "count() as c group by id, name insert into o", {"S": (5, 3)}, {}),
    "join": (
        "from S1#window.length(10) as a join S2#window.time(60) as b "
        "on a.id == b.id select a.timestamp as t, a.name as n, "
        "a.price as p1, b.price as p2 insert into o",
        {"S1": (4, 4), "S2": (4, 5)}, {}),
    "table": (
        "define table T (id int, price double); "
        "from S1[price > 80.0] select id, price insert into T; "
        "from S2[price < 20.0] select id, price update T on T.id == id; "
        "from S2[price > 95.0] select id delete T on T.id == id; "
        "from S2 join T on S2.id == T.id "
        "select S2.id as id, S2.price as p2, T.price as p1 insert into o",
        {"S1": (30, 6), "S2": (30, 7)}, {}),
    "session_window": (
        "from S#window.session(25 ms, id) select id, count() as c, "
        "sum(price) as s, max(price) as hi insert into o",
        {"S": (20, 8)}, {}),
    # three tenants on one shared prefix (a string predicate: the mid
    # rows' codes cross the loopback), the file's "shared" block
    "shared_fleet": (
        "from S[name != 'gamma' and price > 30.0][id == 1] "
        "select timestamp as t, name as n, price as p insert into o; "
        "from S[name != 'gamma' and price > 30.0]#window.lengthBatch(4) "
        "select sum(price) as s insert into o; "
        "from every s1 = S[name != 'gamma' and price > 30.0 and id == 2] "
        "-> s2 = S[name != 'gamma' and price > 30.0 and name == 'beta'] "
        "within 1 sec select s1.timestamp as t1, s2.price as p "
        "insert into o",
        {"S": (4, 10)}, {"share_subplans": True}),
}


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("name", sorted(CROSS))
def test_checkpoint_file_moves_between_packages(tmp_path, name, writer):
    """One package runs half the stream and saves a file; a fresh job of
    each package restores it and runs to the end: the port's rows after
    the restore equal the reference's. The writer's rows before the save
    plus its own restored rows equal its uninterrupted run."""
    cql, spec, config = CROSS[name]
    n, batch = 1200, 100
    streams = {sid: _columns(n, n_ids, seed, offset=3 * i)
               for i, (sid, (n_ids, seed)) in enumerate(spec.items())}
    first = _build(writer, cql, streams, batch, config)
    first.run(max_cycles=5)
    assert not first.finished
    path = str(tmp_path / "ck")
    first.save_checkpoint(path)
    if config.get("share_subplans"):
        shared = first.snapshot()["shared"]
        assert len(shared) == 1
        assert sorted(next(iter(shared.values()))["members"]) == [
            "t0", "t1", "t2"]
    rows = {}
    for pkg in ("jax", "torch"):
        job = _build(pkg, cql, streams, batch, config, control=False)
        job.restore(path)
        if config.get("share_subplans"):
            assert job.control_status()["shared"], pkg
        job.run()
        rows[pkg] = job.results_with_ts("o")
    assert rows["jax"], f"{name}: no rows after the restore"
    _same_rows(rows["torch"], rows["jax"], name)
    whole = _build(writer, cql, streams, batch, config)
    whole.run()
    split = first.results_with_ts("o") + rows[writer]
    if config.get("lazy_projection"):
        # partials carried across the restore decode their lazy columns
        # as None: the rows equal elsewhere
        assert len(split) == len(whole.results_with_ts("o"))
        split = [r for r in split if None not in r[1]]
        kept = {r for r in split}
        assert kept <= set(whole.results_with_ts("o"))
    else:
        _same_rows(sorted(split), sorted(whole.results_with_ts("o")),
                   f"{name}: split against whole")


def _control_timeline(pkg, block):
    """Chain variants that fold into one group, a filter, a pause; for
    ``control_pending`` the later half still waits behind the watermark
    when the file is saved (ts 4,493 after five tapes)."""
    if pkg == "torch":
        from flink_siddhi_tpu_torch.control import events as ev
    else:
        from flink_siddhi_tpu.control import events as ev

    def chain(a, b, w):
        return (f"from every s1 = S[id == {a}] -> s2 = S[id == {b}] "
                f"within {w} sec select s1.timestamp as t1, "
                f"s2.price as p insert into o")

    add = ev.MetadataControlEvent.builder()
    add.add_execution_plan(chain(1, 2, 2), plan_id="c1")
    add.add_execution_plan(chain(3, 4, 1), plan_id="c2")
    later = ev.MetadataControlEvent.builder()
    later.add_execution_plan(chain(2, 5, 3), plan_id="c3")
    later.add_execution_plan(
        "from S[id == 0] select timestamp as t1, price as p insert into o",
        plan_id="f")
    late = 6000 if block == "control_pending" else 1500
    return [(0, add.build()),
            (2500, ev.OperationControlEvent.disable_query("c2")),
            (late, later.build()),
            (late + 800, ev.OperationControlEvent.disable_query("c1")),
            (late + 2000, ev.OperationControlEvent.enable_query("c2"))]


def _control_job(pkg, block, streams, control):
    Schema, Batch, Source, compile_plan, Job, _, kw = PKGS[pkg]
    if pkg == "torch":
        from flink_siddhi_tpu_torch.runtime.sources import ControlListSource
    else:
        from flink_siddhi_tpu.runtime.sources import ControlListSource
    schema = Schema(SCHEMA_FIELDS)
    data = dict(streams)
    codes = np.array([schema.string_tables["name"].intern(n)
                      for n in NAMES], np.int32)
    data["name"] = codes[data["name"]]
    batches = [Batch("S", schema, {k: v[s:s + 100] for k, v in data.items()},
                     data["timestamp"][s:s + 100])
               for s in range(0, len(data["timestamp"]), 100)]
    return Job([], [Source("S", schema, batches)], batch_size=100,
               time_mode="event",
               control_sources=([ControlListSource(
                   _control_timeline(pkg, block))] if control else []),
               plan_compiler=lambda cql, pid: compile_plan(
                   cql, {"S": schema}, plan_id=pid), **kw)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("block", ["dynamic", "control_pending"])
def test_control_blocks_move_between_packages(tmp_path, block, writer):
    """A job driven by control events saves a file mid-stream with its
    ``dynamic`` block (folded group members, one disabled) and, for
    ``control_pending``, events still behind the watermark; a fresh job of
    each package (no control source: what is pending rides the file)
    restores it and runs to the end. The rows after the restore, the plan
    ids and the group slots agree between the packages, and the writer's
    rows before the save plus after it equal its uninterrupted run."""
    cols = _columns(1200, 6, 9)
    first = _control_job(writer, block, cols, control=True)
    first.run(max_cycles=5)
    assert not first.finished
    path = str(tmp_path / "ck")
    first.save_checkpoint(path)
    snap = first.snapshot()
    assert snap["dynamic"]["folded"]
    assert bool(snap["control_pending"]) == (block == "control_pending")
    out = {}
    for pkg in ("jax", "torch"):
        job = _control_job(pkg, block, cols, control=False)
        job.restore(path)
        job.run()
        out[pkg] = (sorted(job.results_with_ts("o")), sorted(job.plan_ids),
                    sorted(job._folded.items()),
                    sorted(job._folded_enabled.items()))
    assert out["torch"] == out["jax"]
    whole = _control_job(writer, block, cols, control=True)
    whole.run()
    split = sorted(first.results_with_ts("o") + out[writer][0])
    assert split == sorted(whole.results_with_ts("o"))
    assert len(out["jax"][0]) > 20


def test_jax_snapshot_dict_restores_into_the_port():
    """The in-memory snapshot of a JAX ``Job`` (not only its file) loads
    into the port: the reference's flight-recorder journal restores with
    it (the restore's entry continues its seq), and its empty later blocks
    pass."""
    cql, spec, config = CROSS["group_by_window"]
    streams = {"S": _columns(600, 5, 3)}
    ref = _build("jax", cql, streams, 100, config)
    ref.run(max_cycles=3)
    snap = ref.snapshot()
    assert snap["flightrec"]  # the reference journals
    job = _build("torch", cql, streams, 100, config)
    job.restore(snap)
    assert job.flightrec.seq == snap["flightrec"]["seq"] + 1
    assert job.flightrec.events()[-1]["kind"] == "checkpoint.restore"
    ref2 = _build("jax", cql, streams, 100, config)
    ref2.restore(snap)
    job.run()
    ref2.run()
    _same_rows(job.results_with_ts("o"), ref2.results_with_ts("o"),
               "dict snapshot")
