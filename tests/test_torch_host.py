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
* Every zoo plan outside the slices ported so far raises
  ``SiddhiQLError`` naming the torch port, instead of running something
  else.
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
    "compiler/config.py", "compiler/output.py",
]


@pytest.mark.parametrize("rel", _COPIED)
def test_copied_module_is_identical_to_its_original(rel):
    original = (_REPO / "flink_siddhi_tpu" / rel).read_bytes()
    assert (_PORT / rel).read_bytes() == original


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
    assert cuda_ops.launch_counts() == {
        "multi_reverse_cummin": 0, "chain_advance": 0,
        "unique_window_fold": 0,
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
    assert cuda_ops.LIBRARIES._libs == {}
    assert cuda_ops.launch_counts() == {
        "multi_reverse_cummin": 0, "chain_advance": 0,
        "unique_window_fold": 0,
    }


_OUTSIDE_SLICE = sorted(
    set(PLAN_ZOO) - {"filter_select", "chain_pattern",
                     "chain_pattern_within", "pattern_absence",
                     "multiquery_stack6", "unique_window", "sort_window"}
)


@pytest.mark.parametrize("name", _OUTSIDE_SLICE)
def test_zoo_plans_outside_the_slice_raise(name):
    schemas = {
        sid: fpt.StreamSchema(
            [(n, t.value) for n, t in zip(s.field_names, s.field_types)]
        )
        for sid, s in zoo_schemas().items()
    }
    with pytest.raises(SiddhiQLError, match="torch port"):
        fpt.compile_plan(PLAN_ZOO[name], schemas)


def test_engine_config_wire_options_raise():
    schema = fpt.StreamSchema([("id", "int")])
    for opt in ("lazy_projection", "pred_pushdown"):
        cfg = EngineConfig(**{opt: True})
        with pytest.raises(SiddhiQLError, match="torch port"):
            fpt.compile_plan("from S[id == 1] select id insert into o",
                             {"S": schema}, config=cfg)


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
