"""Host-side contract of the torch port (CPU lane).

* The copied pure-Python modules stay byte-identical to their originals,
  and the port's parser and planner give the same AST and stream
  partitions as the JAX package for every plan-zoo entry.
* ``flink_siddhi_tpu_torch`` imports neither ``jax`` nor anything of
  ``flink_siddhi_tpu`` (a subprocess import, because this test process
  already imported JAX through tests/conftest.py; and a source scan).
* The port runs on the CUDA device by default and raises without one; a
  kernel wrapper takes its plain version for CPU tensors only (its launch
  counter stays 0) and raises for any other device.
* Every zoo plan compiles in the port, and every form still refused
  raises ``SiddhiQLError`` naming its ROADMAP item, instead of running
  something else.
"""

import dataclasses
import enum
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flink_siddhi_tpu.analysis.zoo import PLAN_ZOO, zoo_schemas
from flink_siddhi_tpu.query import parse_plan as jax_parse_plan
from flink_siddhi_tpu.query.planner import (
    infer_stream_partitions as jax_partitions,
)

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler import cuda_ops
from flink_siddhi_tpu_torch.compiler import slot_program as sp
from flink_siddhi_tpu_torch.compiler.config import EngineConfig
from flink_siddhi_tpu_torch.query import parse_plan as torch_parse_plan
from flink_siddhi_tpu_torch.query.lexer import SiddhiQLError
from flink_siddhi_tpu_torch.query.planner import (
    infer_stream_partitions as torch_partitions,
)

torch.set_num_threads(2)

_REPO = Path(__file__).resolve().parent.parent
_PORT = _REPO / "flink_siddhi_tpu_torch"

# modules the port keeps as exact copies (they contain no JAX, but
# importing them from flink_siddhi_tpu would run its __init__, which does)
_COPIED = [
    "schema/__init__.py", "schema/types.py", "schema/strings.py",
    "schema/stream_schema.py", "schema/batch.py", "schema/encoders.py",
    "query/__init__.py", "query/lexer.py", "query/ast.py",
    "query/parser.py", "query/planner.py",
    "compiler/config.py", "compiler/output.py", "utils/cron.py",
    "telemetry/histogram.py", "telemetry/spans.py", "telemetry/registry.py",
    "telemetry/flightrec.py", "telemetry/tracing.py", "telemetry/slo.py",
    "telemetry/attribution.py", "telemetry/prober.py",
    "runtime/faultinject.py", "runtime/supervisor.py",
    "connectors/__init__.py", "connectors/kafka/__init__.py",
    "connectors/kafka/varint.py", "connectors/kafka/crc32c.py",
    "connectors/kafka/errors.py", "connectors/kafka/codecs.py",
    "connectors/kafka/retry.py", "connectors/kafka/protocol.py",
    "connectors/kafka/records.py", "connectors/kafka/txn.py",
    "runtime/kafka.py", "native/fast_decode.cpp", "control/events.py",
]


@pytest.mark.parametrize("rel", _COPIED)
def test_copied_module_is_identical_to_its_original(rel):
    original = (_REPO / "flink_siddhi_tpu" / rel).read_bytes()
    assert (_PORT / rel).read_bytes() == original


def _to_port(text):
    """The reference's text with its package imports pointed at the port
    (and ``tests.fake_kafka`` at ``tests.torch_fake_kafka``)."""
    text = re.sub(r"^(\s*)from flink_siddhi_tpu\.", r"\1from flink_siddhi_tpu_torch.",
                  text, flags=re.MULTILINE)
    return re.sub(r"^(\s*)from tests\.fake_kafka import",
                  r"\1from tests.torch_fake_kafka import", text,
                  flags=re.MULTILINE)


# test-side copies: the reference's broker and its wire-format cases,
# with only their imports pointed at the port
_COPIED_TESTS = [
    ("fake_kafka.py", "torch_fake_kafka.py"),
    ("test_connectors_kafka.py", "test_torch_connectors_kafka.py"),
]


@pytest.mark.parametrize("original,copy", _COPIED_TESTS)
def test_copied_test_module_differs_only_in_its_imports(original, copy):
    tests = _REPO / "tests"
    ref = (tests / original).read_text()
    got = (tests / copy).read_text()
    assert got == _to_port(ref)
    assert got != ref


def _plain(obj):
    """dataclasses.asdict output with enums reduced to (class, value): the
    two packages' AttributeType classes are distinct objects."""
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.value)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


@pytest.mark.parametrize("name", sorted(PLAN_ZOO))
def test_parser_and_planner_match_jax_on_zoo(name):
    jp = jax_parse_plan(PLAN_ZOO[name])
    tp = torch_parse_plan(PLAN_ZOO[name])
    assert _plain(dataclasses.asdict(tp)) == _plain(dataclasses.asdict(jp))
    jparts = jax_partitions(jp.queries)
    tparts = torch_partitions(tp.queries)
    assert {k: _plain(dataclasses.asdict(v)) for k, v in tparts.items()} \
        == {k: _plain(dataclasses.asdict(v)) for k, v in jparts.items()}


def test_import_pulls_in_no_jax():
    code = (
        "import sys, flink_siddhi_tpu_torch\n"
        "import flink_siddhi_tpu_torch.compiler.cuda_ops\n"
        "import flink_siddhi_tpu_torch.runtime.checkpoint\n"
        "import flink_siddhi_tpu_torch.runtime.supervisor\n"
        "import flink_siddhi_tpu_torch.runtime.faultinject\n"
        "import flink_siddhi_tpu_torch.runtime.kafka\n"
        "import flink_siddhi_tpu_torch.app.pipeline\n"
        "import flink_siddhi_tpu_torch.app.service\n"
        "import flink_siddhi_tpu_torch.control.plane\n"
        "import flink_siddhi_tpu_torch.native\n"
        "import flink_siddhi_tpu_torch.telemetry.flightrec\n"
        "import flink_siddhi_tpu_torch.telemetry.tracing\n"
        "import flink_siddhi_tpu_torch.telemetry.slo\n"
        "import flink_siddhi_tpu_torch.telemetry.attribution\n"
        "import flink_siddhi_tpu_torch.telemetry.prober\n"
        "import flink_siddhi_tpu_torch.telemetry.compile_events\n"
        "import flink_siddhi_tpu_torch.telemetry.openmetrics\n"
        "from flink_siddhi_tpu_torch.telemetry.openmetrics import "
        "_build_info_labels\n"
        "_build_info_labels('cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'flink_siddhi_tpu' "
        "or m.startswith('flink_siddhi_tpu.') or m == 'triton')\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(_REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


_BAD_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|flink_siddhi_tpu)\b(?!_torch)"
    r"|from\s+(?:jax|flink_siddhi_tpu)\b(?!_torch))",
    re.MULTILINE,
)


def test_port_sources_import_no_jax_and_no_reference_package():
    files = sorted(_PORT.rglob("*.py"))
    assert len(files) > 20
    offenders = [
        str(f.relative_to(_REPO))
        for f in files
        if _BAD_IMPORT.search(f.read_text())
    ]
    assert offenders == []
    broker = (_REPO / "tests" / "torch_fake_kafka.py").read_text()
    assert _BAD_IMPORT.search(broker) is None
    smoke = (_REPO / "chip_smoke.py").read_text()
    assert _BAD_IMPORT.search(smoke) is None
    assert "import bench" not in smoke


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    schema = fpt.StreamSchema([("id", "int"), ("timestamp", "long")])
    plan = fpt.compile_plan(
        "from S[id == 2] select id insert into out", {"S": schema}
    )
    src = fpt.BatchSource("S", schema, iter(()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fpt.Job([plan], [src])
    with pytest.raises(RuntimeError, match="CUDA"):
        fpt.CEPEnvironment()
    with pytest.raises(RuntimeError, match="CUDA"):
        fpt.SiddhiCEP.define("S", [(1, 1000)], ["id", "timestamp"])
    # an explicit CPU device is the caller's choice and runs
    job = fpt.Job([plan], [src], device="cpu")
    assert job.device == torch.device("cpu")


def test_kernel_wrappers_take_plain_version_for_cpu_tensors_only():
    cuda_ops.reset_launches()
    x = torch.tensor([[4, 2, 9, 1], [0, 5, 3, 7]], dtype=torch.int32)
    assert cuda_ops.multi_reverse_cummin(x).tolist() == [
        [1, 1, 1, 1], [0, 3, 3, 7]
    ]
    E, V = 4, 3
    nxt = torch.tensor([[1, 1, 3, 3, 4]], dtype=torch.int32)
    out = cuda_ops.chain_advance(
        nxt, [0], [[]], torch.arange(E + 1, dtype=torch.int32),
        torch.ones(V, dtype=torch.bool), torch.ones(V, dtype=torch.int32),
        torch.tensor([0, 2, 4], dtype=torch.int32),
        torch.zeros(V, dtype=torch.int32), None,
    )
    assert out[3].tolist() == [[1, 3, E]]
    valid, bufs, rows = cuda_ops.unique_window_fold(
        torch.tensor([True, False, True]),
        torch.tensor([1, 0, 1], dtype=torch.int32),
        torch.tensor([[2.0, 9.0, 5.0]]), torch.zeros(2, dtype=torch.bool),
        torch.zeros((1, 2)), [("count", -1), ("sum", 0)],
    )
    assert rows.tolist() == [[1.0, 1.0, 1.0], [2.0, 2.0, 5.0]]
    assert valid.tolist() == [False, True] and bufs.tolist() == [[0.0, 5.0]]
    # K4's plain version: one event arms a slot of a sequence
    art = fpt.compile_plan(
        "from every a = S[id == 1], b = S[id == 2] "
        "select a.timestamp as t insert into o",
        {"S": fpt.StreamSchema([("id", "int"), ("timestamp", "long")])},
    ).artifacts[0]
    mat, scal = art._pack_state(art.init_state("cpu"))
    one = torch.ones(1, dtype=torch.int32)
    mat, scal, buf = cuda_ops.slot_nfa_scan(
        art.scan_plan, mat, scal, one * 5, torch.ones(1, dtype=torch.bool),
        one, one, torch.stack([one * 5]),
    )
    assert mat[0].tolist()[:2] == [1, 0] and scal.tolist() == [0, 1, 0, 0]
    assert tuple(buf.shape) == (2, 1 + art.slots)
    # K6's plain version: the last of two matching events wins row 0
    last = cuda_ops.table_mutate(
        torch.tensor([True, True, False]),
        torch.tensor([[7, 7, 7]], dtype=torch.int32),
        torch.tensor([True, True]),
        torch.tensor([[7, 8]], dtype=torch.int32),
        (sp.OP_EVT, sp.OP_CAP, sp.OP_EQ_I), 2,
    )
    assert last.tolist() == [1, -1]
    # K7-K9's plain versions: a session closes, a key is counted, an
    # event is inserted into a sort buffer
    f32 = torch.float32
    out = cuda_ops.session_scan(
        torch.tensor([True, True]), torch.zeros(2, dtype=torch.int32),
        torch.tensor([10, 50], dtype=torch.int32), torch.tensor([[1.0, 2.0]]),
        torch.zeros(1, dtype=torch.bool), torch.zeros(1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), torch.zeros((1, 1)),
        torch.full((1, 1), float("inf")), torch.full((1, 1), float("-inf")),
        5)
    assert out[6].tolist() == [False, True] and out[8].tolist() == [0, 1]
    out = cuda_ops.frequency_scan(
        torch.tensor([True, True]), torch.tensor([3, 3], dtype=torch.int32),
        torch.tensor([[1.0, 2.0]]), torch.zeros(2, dtype=torch.bool),
        torch.full((2,), -1, dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
        torch.tensor(0, dtype=torch.int32), torch.zeros((1, 2)),
        [("count", -1), ("sum", 0)], (), False, 0, 0.0, 4)
    assert out[2].tolist() == [2, 0] and out[7].tolist() == [
        [1.0, 1.0], [1.0, 2.0]]
    out = cuda_ops.sort_window_scan(
        torch.tensor([True, True]), torch.zeros(2, dtype=torch.int32),
        torch.tensor([5.0, 3.0]), torch.tensor([[5.0, 3.0]]),
        torch.zeros((1, 2), dtype=torch.bool), torch.zeros((1, 2), dtype=f32),
        torch.zeros((1, 1, 2)), [("min", 0)])
    assert out[1].tolist() == [[3.0, 5.0]] and out[3].tolist() == [[5.0, 3.0]]
    assert cuda_ops.launch_counts() == {
        "multi_reverse_cummin": 0, "chain_advance": 0,
        "unique_window_fold": 0, "slot_nfa_scan": 0, "join_pairs": 0,
        "table_mutate": 0, "session_scan": 0, "frequency_scan": 0,
        "sort_window_scan": 0,
    }
    # a tensor on any other device is refused, never quietly computed
    meta = torch.empty((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_ops.multi_reverse_cummin(meta)
    assert cuda_ops.launch_counts()["multi_reverse_cummin"] == 0


def test_cpu_run_builds_no_kernel():
    # a chain plan run on the CPU goes through both wrappers' plain
    # versions: no nvcc, no kernel library loaded, no launch counted
    cuda_ops.reset_launches()
    rows = fpt.SiddhiCEP.define(
        "S", [(i % 3, 1000 + i) for i in range(30)], ["id", "timestamp"],
        device="cpu",
    ).cql(
        "from every a = S[id == 1] -> b = S[id == 2] "
        "select a.timestamp as t1, b.timestamp as t2 insert into o"
    ).returns("o")
    assert rows[0] == (1001, 1002) and len(rows) == 10
    # and a slot-NFA pattern through K4's plain version
    rows = fpt.SiddhiCEP.define(
        "S", [(i % 3, 1000 + i) for i in range(30)], ["id", "timestamp"],
        device="cpu",
    ).cql(
        "from every a = S[id == 1]<2:3> -> b = S[id == 2] "
        "select a[0].timestamp as t1, a[1].timestamp as t2, "
        "b.timestamp as t3 insert into o"
    ).returns("o")
    assert rows[0] == (1001, 1004, 1005) and len(rows) == 9
    assert cuda_ops.LIBRARIES._libs == {}
    assert cuda_ops.launch_counts() == {
        "multi_reverse_cummin": 0, "chain_advance": 0,
        "unique_window_fold": 0, "slot_nfa_scan": 0, "join_pairs": 0,
        "table_mutate": 0, "session_scan": 0, "frequency_scan": 0,
        "sort_window_scan": 0,
    }


@pytest.mark.parametrize("name", sorted(PLAN_ZOO))
def test_every_zoo_plan_compiles_in_the_port(name):
    # the whole zoo is inside the port since its joins and chaining came
    schemas = {
        sid: fpt.StreamSchema(
            [(n, t.value) for n, t in zip(s.field_names, s.field_types)]
        )
        for sid, s in zoo_schemas().items()
    }
    plan = fpt.compile_plan(PLAN_ZOO[name], schemas)
    assert plan.artifacts


@pytest.mark.parametrize("cql,item", [
    ("define table T (id int); from S#window.length(2) select id "
     "insert into T", None),
    ("define table T (id int); from S join T on math:abs(S.id - T.id) < 2 "
     "select S.id insert into o", 8),
    ("define table T (id int); from S select id, count() as c group by id "
     "update T on T.id == id", None),
    ("define table T (id int); from S#window.lengthBatch(2) select id "
     "delete T on T.id == id", None),
    ("define table T (id int); from S#window.length(2) select id "
     "update T on T.id == id", None),
    ("from S#window.session(5 sec) select id, count() as c insert into o",
     "#window.session select items must be the session key or "
     "aggregations"),
    ("partition with (id of S) begin from S select id insert into o; end",
     None),
    ("partition with (id of S) begin from S#window.length(2) as a join "
     "S#window.length(2) as b on a.id == b.id select a.id insert into o; "
     "end", "joins inside 'partition with' are not supported yet"),
    ("from S#window.length(4) as a join S#window.length(4) as b "
     "on math:abs(a.id - b.id) < 2 select a.id insert into o", 8),
    ("from S select id output last every 2 events insert into o", None),
    ("partition with (id of S) begin from S#window.unique(id) select id, "
     "count() as c insert into o; end", 8),
    ("from S select id output snapshot every 1 sec insert into o",
     "'output snapshot every ...' is supported for aggregation queries"),
    ("from S select id, count() as c group by id, timestamp output "
     "snapshot every 1 sec insert into o",
     "'output snapshot' on a group-by query must project every group key "
     "in the select (missing: ['timestamp'])"),
    ("from S[id > 1] select id output last every 2 events insert into o; "
     "from S[id < 1] select id insert into o",
     "output rate limiting on 'o' with multiple writer queries is not "
     "supported yet"),
    ("from S select id output last every 2 events insert into m; "
     "from m#window.length(2) select id insert into o",
     "output rate limiting on chained stream 'm' is not supported"),
    ("define table T (id int); from S select id output all every 2 events "
     "insert into T",
     "output rate limiting on a table write is not supported"),
], ids=["table", "table_join", "table_update", "table_delete",
        "windowed_mutation", "session_window", "partition",
        "partition_join", "on_call_both_sides", "output_rate",
        "partition_unique", "output_snapshot_plain",
        "output_snapshot_keys", "output_rate_two_writers",
        "output_rate_chained", "output_rate_table"])
def test_refused_forms_name_their_roadmap_item(cql, item):
    # every form still outside the port names the ROADMAP item it waits
    # for; a form that came into the port compiles (None), and one the
    # reference refuses itself carries the reference's text (a str).
    # Joins, chained queries, 'insert all events', the table writes and
    # joins, windowed table writes and partitions were item 8 until they
    # came: the cases kept their ids. So was the session window, whose
    # case (a plain attribute beside the aggregate) the reference refuses.
    schema = fpt.StreamSchema([("id", "int"), ("timestamp", "long")])
    if item is None:
        assert fpt.compile_plan(cql, {"S": schema}).artifacts
        return
    match = (re.escape(item) if isinstance(item, str)
             else f"item {item}\\b")
    with pytest.raises(SiddhiQLError, match=match):
        fpt.compile_plan(cql, {"S": schema})


def test_engine_config_wire_options_leave_raw_group_column_off():
    # the wire options compile for a plan of one select (and one chain,
    # tests/test_torch_replay.py); over a grouped sliding window, lazy
    # projection ships the group's code in place of its raw column (the
    # reference's window_wire_opts), and pushdown alone changes nothing
    schema = fpt.StreamSchema([("id", "int"), ("v", "int")])
    for opt in ("lazy_projection", "pred_pushdown"):
        cfg = EngineConfig(**{opt: True})
        plan = fpt.compile_plan("from S[id == 1] select v insert into o",
                                {"S": schema}, config=cfg)
        assert plan.spec.device_columns is not None
        plan = fpt.compile_plan(
            "from S[v > 0]#window.length(4) select id, sum(v) as s "
            "group by id insert into o", {"S": schema}, config=cfg,
        )
        if opt == "lazy_projection":
            assert plan.spec.device_columns == ("S.v",)
            assert plan.artifacts[0].group_code_proj == (0, None)
        else:
            assert plan.spec.device_columns is None


def test_state_from_numpy_rejects_mismatched_state():
    schema = fpt.StreamSchema([("id", "int"), ("timestamp", "long")])
    plan = fpt.compile_plan(
        "from every a = S[id == 1] -> b = S[id == 2] "
        "select a.timestamp as t insert into o", {"S": schema},
    )
    good = {k: v.numpy() for k, v in plan.init_state("cpu")["query_0"].items()}
    st = fpt.state_from_numpy(plan, {"query_0": good}, "cpu")
    assert st["query_0"]["active"].dtype == torch.bool
    bad = dict(good, step=good["step"].astype(np.int64))
    with pytest.raises(ValueError, match="step"):
        fpt.state_from_numpy(plan, {"query_0": bad}, "cpu")
    with pytest.raises(KeyError):
        fpt.state_from_numpy(plan, {"query_0": {"active": good["active"]}},
                             "cpu")
