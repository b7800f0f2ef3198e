"""The port's admission analysis (``analysis/admit.py``), held to the
reference's verdicts.

The cases of ``tests/test_admit.py`` on the port's plans: every zoo
entry is admitted under the default budgets with finite bounds, and its
verdict under the default and the strict profile equals the reference's;
every hostile zoo entry is refused by the reference's exact rule id; the
footprint (the port's own: ``init_state`` and ``init_acc`` read on meta
tensors) dominates the state a CPU job holds after stepping; a missing or
malformed cost hook is ADM001 / ADM002; the budget knobs act one by one;
``compile_plan`` refuses under ``EngineConfig.admission_budgets``. The
port's ``plan_signature`` hashes the port's own shapes, so it is held to
the reference's properties (constants collide, shape and bucket
boundaries split, a fresh process derives the same key), and the
per-segment signatures, which read only the query AST, equal the
reference's. A verdict rides a metadata event through its JSON form and
a refused one keeps the add from the stack.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flink_siddhi_tpu.analysis import admit as j_admit
from flink_siddhi_tpu.analysis.zoo import HOSTILE_ZOO, PLAN_ZOO, hostile_budgets
from flink_siddhi_tpu.analysis.zoo import zoo_schemas as j_zoo_schemas
from flink_siddhi_tpu.compiler.plan import compile_plan as j_compile

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.analysis.admit import (
    ADM_RULES,
    AdmissionBudgets,
    AdmissionError,
    DEFAULT_BUDGETS,
    STRICT_BUDGETS,
    admit_plan,
    analyze_plan,
    plan_signature,
    segment_signatures,
)
from flink_siddhi_tpu_torch.compiler.config import EngineConfig
from flink_siddhi_tpu_torch.compiler.plan import compile_plan
from flink_siddhi_tpu_torch.schema.stream_schema import StreamSchema
from flink_siddhi_tpu_torch.schema.types import AttributeType

torch.set_num_threads(2)

REPO = str(Path(__file__).resolve().parent.parent)


def zoo_schemas():
    return {
        "S": StreamSchema([
            ("id", AttributeType.INT), ("name", AttributeType.STRING),
            ("price", AttributeType.DOUBLE),
            ("timestamp", AttributeType.LONG),
        ]),
        "Trades": StreamSchema([
            ("sym", AttributeType.STRING), ("price", AttributeType.DOUBLE),
            ("vol", AttributeType.INT), ("timestamp", AttributeType.LONG),
        ]),
    }


@pytest.fixture(scope="module")
def zoo():
    return {n: compile_plan(cql, zoo_schemas(), plan_id=f"zoo:{n}")
            for n, cql in PLAN_ZOO.items()}


def _port_budgets(profile):
    return {"default": DEFAULT_BUDGETS, "strict": STRICT_BUDGETS}[profile]


def _sig(cql, capacity=128, plan_id="p"):
    plan = compile_plan(cql, zoo_schemas(), plan_id=plan_id)
    return plan_signature(plan, capacity=capacity)


# -- resource bounds --------------------------------------------------------

def test_all_zoo_entries_admitted_with_finite_bounds(zoo):
    for name, plan in zoo.items():
        rep = analyze_plan(plan, budgets=DEFAULT_BUDGETS)
        assert rep.admitted, (name, [i.render() for i in rep.findings])
        assert isinstance(rep.state_bytes, int) and rep.state_bytes >= 0
        assert isinstance(rep.acc_bytes, int) and rep.acc_bytes > 0
        assert 0 <= rep.amplification < 1 << 20
        assert rep.signature is not None
        assert len(rep.per_artifact) == len(plan.artifacts)


@pytest.mark.parametrize("profile", ["default", "strict"])
def test_zoo_verdicts_match_the_reference(zoo, profile):
    """Each zoo plan's verdict (admitted, and the rule ids it trips)
    under each budget profile equals the reference's."""
    for name, plan in zoo.items():
        got = analyze_plan(plan, budgets=_port_budgets(profile))
        ref = j_admit.analyze_plan(
            j_compile(PLAN_ZOO[name], j_zoo_schemas(), plan_id=f"zoo:{name}"),
            budgets=hostile_budgets(profile))
        assert got.admitted == ref.admitted, name
        assert sorted(i.rule for i in got.findings) == sorted(
            i.rule for i in ref.findings), name
        assert got.residency_ms == ref.residency_ms, name


@pytest.mark.parametrize("entry", sorted(HOSTILE_ZOO), ids=sorted(HOSTILE_ZOO))
def test_hostile_zoo_rejected_by_exact_rule(entry):
    cql, expected_rule, profile = HOSTILE_ZOO[entry]
    plan = compile_plan(cql, zoo_schemas(), plan_id=f"hostile:{entry}")
    rep = analyze_plan(plan, budgets=_port_budgets(profile))
    assert not rep.admitted, entry
    assert expected_rule in {i.rule for i in rep.findings}, (
        entry, [i.render() for i in rep.findings])
    assert expected_rule in ADM_RULES
    ref = j_admit.analyze_plan(
        j_compile(cql, j_zoo_schemas(), plan_id=f"hostile:{entry}"),
        budgets=hostile_budgets(profile))
    assert {i.rule for i in rep.findings} == {i.rule for i in ref.findings}
    if profile == "default":
        with pytest.raises(AdmissionError) as ei:
            admit_plan(plan, budgets=DEFAULT_BUDGETS)
        assert expected_rule in {i.rule for i in ei.value.issues}


def test_rule_table_matches_the_reference():
    assert sorted(ADM_RULES) == sorted(j_admit.ADM_RULES)
    assert dataclasses.asdict(DEFAULT_BUDGETS) == dataclasses.asdict(
        j_admit.DEFAULT_BUDGETS)
    assert dataclasses.asdict(STRICT_BUDGETS) == dataclasses.asdict(
        j_admit.STRICT_BUDGETS)


def _nbytes(tree):
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


@pytest.mark.parametrize(
    "name", ["length_window_agg", "chain_pattern", "multiquery_stack6",
             "time_window_groupby", "unique_window"])
def test_footprint_bound_dominates_measured_state(name, zoo):
    """The reported footprint is at least the state a CPU job holds after
    stepping a tape of 50 ids through the plan (the admission-time
    shapes are what init builds, and no state of these plans grows past
    them at this cardinality)."""
    plan = compile_plan(PLAN_ZOO[name], zoo_schemas(), plan_id=name)
    rep = analyze_plan(plan, budgets=DEFAULT_BUDGETS)
    schema = plan.schemas["S"]
    n = 2048
    rng = np.random.default_rng(1)
    ts = 1000 + np.arange(n, dtype=np.int64)
    batch = fpt.EventBatch("S", schema, {
        "id": rng.integers(0, 50, n).astype(np.int32),
        "name": np.zeros(n, np.int32),
        "price": rng.random(n) * 100, "timestamp": ts}, ts)
    job = fpt.Job([plan], [fpt.BatchSource("S", schema, iter([batch]))],
                  batch_size=n, device="cpu")
    job.set_admitted_footprint(
        name, job.admitted_bytes(rep.state_bytes, rep.acc_bytes))
    job.run()
    rt = job._plans[name]
    actual = _nbytes(rt.states)
    assert actual > 0
    assert rep.state_bytes >= actual, (name, rep.state_bytes, actual)
    fp = job.footprint_status()[name]
    assert fp["measured_bytes"] <= fp["admitted_bytes"]
    assert job.telemetry.snapshot()["counters"].get(
        "footprint.overruns", 0) == 0


def test_footprint_meter_counts_an_overrun():
    plan = compile_plan(PLAN_ZOO["filter_select"], zoo_schemas(),
                        plan_id="p")
    job = fpt.Job([plan], [], device="cpu")
    job.set_admitted_footprint("p", 1)
    job._update_footprint(job._plans["p"])
    assert job.telemetry.snapshot()["counters"]["footprint.overruns"] == 1
    st = job.footprint_status()["p"]
    assert st["admitted_bytes"] == 1 and st["measured_bytes"] > 1


def test_missing_cost_info_hook_is_adm001(zoo, monkeypatch):
    from flink_siddhi_tpu_torch.compiler.select import SelectArtifact

    monkeypatch.delattr(SelectArtifact, "cost_info")
    rep = analyze_plan(zoo["filter_select"], budgets=DEFAULT_BUDGETS)
    assert [i.rule for i in rep.findings] == ["ADM001"]


def test_malformed_cost_info_is_adm002(zoo, monkeypatch):
    from flink_siddhi_tpu_torch.compiler.select import SelectArtifact

    monkeypatch.setattr(SelectArtifact, "cost_info",
                        lambda self: {"name": self.name})
    rep = analyze_plan(zoo["filter_select"], budgets=DEFAULT_BUDGETS)
    assert [i.rule for i in rep.findings] == ["ADM002"]


def test_residency_budget_passes_bounded_patterns(zoo):
    ok = analyze_plan(zoo["chain_pattern_within"], budgets=STRICT_BUDGETS)
    assert ok.admitted, [i.render() for i in ok.findings]
    bad = analyze_plan(zoo["chain_pattern"], budgets=STRICT_BUDGETS)
    assert {i.rule for i in bad.findings} == {"ADM110"}


# -- compile_plan wiring ----------------------------------------------------

def test_engineconfig_budgets_reject_at_compile(monkeypatch):
    cql, expected_rule, _ = HOSTILE_ZOO["hostile_length_window_1m"]
    cfg = EngineConfig(admission_budgets=DEFAULT_BUDGETS)
    with pytest.raises(AdmissionError) as ei:
        compile_plan(cql, zoo_schemas(), plan_id="p", config=cfg)
    assert expected_rule in {i.rule for i in ei.value.issues}
    monkeypatch.setenv("FST_VERIFY_PLANS", "0")
    plan = compile_plan(cql, zoo_schemas(), plan_id="p", config=cfg)
    assert plan.plan_id == "p"


def test_budget_knobs_are_enforced_individually(zoo):
    plan = zoo["length_window_agg"]
    for budgets, rule in (
        (AdmissionBudgets(max_state_bytes=16), "ADM101"),
        (AdmissionBudgets(max_acc_bytes=1024), "ADM102"),
        (AdmissionBudgets(max_amplification=0), "ADM120"),
    ):
        got = {i.rule for i in analyze_plan(plan, budgets=budgets).findings}
        assert got == {rule}


# -- shape-bucket plan signatures -------------------------------------------

def test_signature_constants_only_change_collides():
    a = _sig("from S[id == 2] select id, name, price insert into out")
    b = _sig("from S[id == 7] select id, name, price insert into out",
             plan_id="other-tenant")
    assert a == b


def test_signature_time_span_constants_collide():
    a = _sig("from S#window.time(3 sec) select sum(price) as t "
             "insert into out")
    b = _sig("from S#window.time(5 sec) select sum(price) as t "
             "insert into out")
    assert a == b


def test_signature_within_constants_collide_presence_splits():
    p5 = _sig("from every s1 = S[id == 1] -> s2 = S[id == 2] "
              "within 5 sec select s1.price as a insert into out")
    p6 = _sig("from every s1 = S[id == 1] -> s2 = S[id == 2] "
              "within 6 sec select s1.price as a insert into out")
    p0 = _sig("from every s1 = S[id == 1] -> s2 = S[id == 2] "
              "select s1.price as a insert into out")
    assert p5 == p6
    assert p5 != p0


def test_signature_operator_change_splits():
    a = _sig("from S[id == 2] select id, name, price insert into out")
    c = _sig("from S[id > 2] select id, name, price insert into out")
    assert a != c


def test_signature_window_width_across_shape_boundary_splits():
    w16 = _sig("from S#window.length(16) select sum(price) as t "
               "insert into out")
    w17 = _sig("from S#window.length(17) select sum(price) as t "
               "insert into out")
    assert w16 != w17


def test_signature_batch_capacity_buckets():
    q = "from S[id == 2] select id, name, price insert into out"
    assert _sig(q, capacity=100) == _sig(q, capacity=128)
    assert _sig(q, capacity=128) != _sig(q, capacity=129)


_FRESH_ENV = dict(os.environ, FST_VERIFY_PLANS="0",
                  PYTHONPATH=REPO + os.pathsep + os.environ.get(
                      "PYTHONPATH", ""))
_PORT_SCHEMAS = (
    "from flink_siddhi_tpu_torch.schema.stream_schema import StreamSchema\n"
    "from flink_siddhi_tpu_torch.schema.types import AttributeType as T\n"
    "def schemas():\n"
    "    return {'S': StreamSchema([('id', T.INT), ('name', T.STRING),\n"
    "                               ('price', T.DOUBLE),\n"
    "                               ('timestamp', T.LONG)]),\n"
    "            'Trades': StreamSchema([('sym', T.STRING),\n"
    "                                    ('price', T.DOUBLE),\n"
    "                                    ('vol', T.INT),\n"
    "                                    ('timestamp', T.LONG)])}\n"
)


def test_signature_stable_across_process_restart(zoo):
    """The key reproduces in a FRESH process (no Python hash(), no
    id()s, no iteration-order dependence)."""
    names = ["filter_select", "chain_pattern_within", "window_join"]
    here = {n: plan_signature(zoo[n]) for n in names}
    code = (
        "import json\n" + _PORT_SCHEMAS
        + "from flink_siddhi_tpu_torch.analysis.admit import "
        "plan_signature\n"
        "from flink_siddhi_tpu_torch.compiler.plan import compile_plan\n"
        f"zoo = {dict((n, PLAN_ZOO[n]) for n in names)!r}\n"
        "for n, cql in zoo.items():\n"
        "    p = compile_plan(cql, schemas(), plan_id=f'zoo:{n}')\n"
        "    print(n, plan_signature(p))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, timeout=240, check=True, env=_FRESH_ENV,
    ).stdout
    fresh = dict(line.split() for line in out.strip().splitlines())
    assert fresh == here


# -- per-segment prefix signatures (the subplan-share key space) -------------

def _segsigs(cql, plan_id="p"):
    return segment_signatures(
        compile_plan(cql, zoo_schemas(), plan_id=plan_id))


def _j_segsigs(cql, plan_id="p"):
    return j_admit.segment_signatures(
        j_compile(cql, j_zoo_schemas(), plan_id=plan_id))


def test_segment_signatures_share_prefix_split_at_divergence():
    qa = "from S[price > 2.0][id == 1] select id insert into out"
    qb = "from S[price > 2.0][id > 3] select name insert into o2"
    a = _segsigs(qa)[0]
    b = _segsigs(qb, plan_id="other-tenant")[0]
    assert len(a) == len(b) == 4
    assert a[0] == b[0] and a[1] == b[1]
    assert a[2] != b[2] and a[3] != b[3]
    # they read only the query AST: the reference's keys exactly
    assert [a, b] == [_j_segsigs(qa)[0], _j_segsigs(qb)[0]]


def test_segment_signatures_constants_only_change_collides():
    a = _segsigs("from S[price > 2.0][id == 1] select id insert into out")[0]
    b = _segsigs("from S[price > 9.0][id == 7] select id insert into out")[0]
    assert a == b


def test_segment_signatures_structural_prefix_change_splits():
    a = _segsigs("from S[price > 2.0] select id insert into out")[0]
    b = _segsigs("from S[price >= 2.0] select id insert into out")[0]
    assert a[0] == b[0]
    assert a[1] != b[1]


def test_segment_signatures_stable_across_process_restart():
    cqls = [
        "from S[price > 2.0][id == 1] select id insert into out",
        "from S[price > 2.0] select sum(price) as t insert into o2",
        "from every s1 = S[id == 1] -> s2 = S[id == 2] "
        "within 5 sec select s1.price as a insert into o3",
    ]
    here = [_segsigs(c, plan_id=f"q{i}") for i, c in enumerate(cqls)]
    assert here == [_j_segsigs(c, plan_id=f"q{i}")
                    for i, c in enumerate(cqls)]
    code = (
        "import json\n" + _PORT_SCHEMAS
        + "from flink_siddhi_tpu_torch.analysis.admit import "
        "segment_signatures\n"
        "from flink_siddhi_tpu_torch.compiler.plan import compile_plan\n"
        f"for i, c in enumerate({cqls!r}):\n"
        "    p = compile_plan(c, schemas(), plan_id=f'q{i}')\n"
        "    print(json.dumps(segment_signatures(p)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, timeout=240, check=True, env=_FRESH_ENV,
    ).stdout
    import json

    assert [json.loads(line) for line in out.strip().splitlines()] == here


# -- verdicts on the control plane ------------------------------------------

def test_admission_summary_rides_metadata_events_json():
    from flink_siddhi_tpu_torch.control.events import (
        MetadataControlEvent,
        control_event_from_json,
        control_event_to_json,
    )

    plan = compile_plan(PLAN_ZOO["filter_select"], zoo_schemas(),
                        plan_id="t1")
    rep = analyze_plan(plan, budgets=DEFAULT_BUDGETS)
    b = MetadataControlEvent.builder()
    pid = b.add_execution_plan(PLAN_ZOO["filter_select"],
                               admission=rep.summary())
    ev = control_event_from_json(control_event_to_json(b.build()))
    assert ev.admission[pid]["admitted"] is True
    assert ev.admission[pid]["signature"] == rep.signature
    assert ev.admission[pid]["state_bytes"] == rep.state_bytes


def _carried_verdict_run(pk_cep, pk_events, **env_kw):
    @dataclasses.dataclass
    class Event:
        id: int
        price: float
        timestamp: int

    events = [Event(1, float(i), 1000 * (i + 1)) for i in range(6)]
    b = pk_events.MetadataControlEvent.builder()
    pid_ok = b.add_execution_plan("from S select id, price insert into ok",
                                  plan_id="ok")
    pid_bad = b.add_execution_plan(
        "from S select id, price insert into bad", plan_id="bad",
        admission={"admitted": False, "findings": [
            {"rule": "ADM110", "where": "x", "message": "m"}]})
    env = pk_cep.CEPEnvironment(batch_size=2, **env_kw)
    job = pk_cep.SiddhiCEP.define(
        "S", events, ["id", "price", "timestamp"], env=env
    ).cql([(0, b.build())]).execute()
    assert len(job.results("ok")) == len(events)
    assert job.results("bad") == []
    assert pid_bad not in job.plan_ids and pid_ok in job.plan_ids
    snap = job.telemetry.snapshot()
    assert snap["counters"]["control.admission_rejected"] == 1
    return (job.results("ok"), sorted(job.plan_ids),
            job.control_rejections["bad"])


def test_rejected_admission_verdict_refuses_control_add():
    """An add whose carried verdict says admitted=False never reaches the
    compiler or the stack; the rest of the event applies."""
    import flink_siddhi_tpu as jfst
    from flink_siddhi_tpu.control import events as j_events
    from flink_siddhi_tpu_torch.control import events as t_events

    ref = _carried_verdict_run(jfst, j_events)
    got = _carried_verdict_run(fpt, t_events, device="cpu")
    assert got == ref
