"""The port's plan verifier, held to the reference's rule ids.

The cases of ``tests/test_plancheck.py`` on the port's plans: every zoo
entry verifies clean at the trace tier and at the deep tier (one CPU step
over the all-invalid tape; the reference's deep pass covers four entries,
the port's is cheap enough for all of them), and each deliberately broken
plan — a dtype drift, malformed slot-NFA tables, a state signature that
is no fixed point, a pad row that emits — is refused by the rule id the
reference gives the same break of its own plan. The unit cases of
``_check_one_nfa`` run on both packages' functions and must agree.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_siddhi_tpu.analysis import plancheck as j_plancheck
from flink_siddhi_tpu.analysis.zoo import PLAN_ZOO
from flink_siddhi_tpu.analysis.zoo import zoo_schemas as j_zoo_schemas
from flink_siddhi_tpu.compiler.plan import compile_plan as j_compile
from flink_siddhi_tpu.schema.types import AttributeType as JType

from flink_siddhi_tpu_torch.analysis import plancheck as t_plancheck
from flink_siddhi_tpu_torch.analysis.plancheck import (
    PlanCheckError,
    _check_one_nfa,
    verify_plan,
)
from flink_siddhi_tpu_torch.compiler.config import EngineConfig
from flink_siddhi_tpu_torch.compiler.plan import compile_plan
from flink_siddhi_tpu_torch.schema.stream_schema import StreamSchema
from flink_siddhi_tpu_torch.schema.types import AttributeType

torch.set_num_threads(2)


def zoo_schemas():
    """The port's twin of the reference zoo's schemas."""
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


def _fresh(name):
    return compile_plan(PLAN_ZOO[name], zoo_schemas(),
                        plan_id=f"mis:{name}")


def _j_fresh(name):
    return j_compile(PLAN_ZOO[name], j_zoo_schemas(), plan_id=f"mis:{name}")


def _rules_of(plan, **kw):
    return {i.rule for i in verify_plan(plan, raise_on_error=False,
                                        trace=True, **kw)}


def _j_rules_of(plan, **kw):
    return {i.rule for i in j_plancheck.verify_plan(
        plan, raise_on_error=False, trace=True, **kw)}


@pytest.mark.parametrize("name", sorted(PLAN_ZOO))
def test_zoo_entry_verifies_trace_tier(name):
    assert verify_plan(_fresh(name), trace=True) == []


@pytest.mark.parametrize("name", sorted(PLAN_ZOO))
def test_zoo_entry_verifies_deep(name):
    assert verify_plan(_fresh(name), trace=True, deep=True) == []


def test_verify_plans_config_flag_runs_at_compile(monkeypatch):
    monkeypatch.delenv("FST_VERIFY_PLANS", raising=False)
    calls = []
    real = t_plancheck.verify_plan

    def spy(plan, **kw):
        calls.append(kw.get("trace"))
        return real(plan, **kw)

    monkeypatch.setattr(t_plancheck, "verify_plan", spy)
    compile_plan(PLAN_ZOO["filter_select"], zoo_schemas(),
                 config=EngineConfig(verify_plans=True))
    assert calls == [True]
    # the escape hatch turns even an explicit True off
    monkeypatch.setenv("FST_VERIFY_PLANS", "0")
    compile_plan(PLAN_ZOO["filter_select"], zoo_schemas(),
                 config=EngineConfig(verify_plans=True))
    assert calls == [True]
    # the test lane's =1: the static tier on every compile
    monkeypatch.setenv("FST_VERIFY_PLANS", "1")
    compile_plan(PLAN_ZOO["filter_select"], zoo_schemas())
    assert calls == [True, False]


# -- deliberate miscompiles ------------------------------------------------

def _break_dtype(plan, ftype):
    art = plan.artifacts[0]
    sch = art.output_schema
    i = next(i for i, f in enumerate(sch.fields) if f.name == "price")
    fields = list(sch.fields)
    fields[i] = dataclasses.replace(fields[i], atype=ftype)
    art.output_schema = dataclasses.replace(sch, fields=tuple(fields))
    return plan


def test_dtype_mismatch_rejected():
    """A declared DOUBLE column retyped INT while the step emits float32:
    the decode would bitcast garbage (PLC105)."""
    got = _rules_of(_break_dtype(_fresh("filter_select"),
                                 AttributeType.INT))
    ref = _j_rules_of(_break_dtype(_j_fresh("filter_select"), JType.INT))
    assert "PLC105" in got and got == ref


def _break_tables(plan):
    art = plan.artifacts[0]
    art._min_prefix = np.asarray(art._min_prefix[::-1].copy(),
                                 dtype=np.int32)
    art._groups = art._groups[:-1]
    return plan


def test_malformed_nfa_tables_rejected():
    """The slot engine's derived tables corrupted: a non-monotone
    min-count prefix and a group table that lost an element."""
    got = _rules_of(_break_tables(_fresh("slot_nfa_quantified")))
    ref = _j_rules_of(_break_tables(_j_fresh("slot_nfa_quantified")))
    assert "PLC207" in got and "PLC208" in got
    assert {r for r in got if r.startswith("PLC2")} == {
        r for r in ref if r.startswith("PLC2")}


def _nfa_rules(check, info):
    issues = []
    check("p", info, issues)
    return sorted(i.rule for i in issues), [i.message for i in issues]


def test_guard_on_undeclared_element_rejected():
    base = dict(
        name="q", n_elements=3, positive=(0, 2), guards=((), (1,)),
        t_guard=None, negated=(False, False, False),
        quantifiers=((1, 1), (1, 1), (1, 1)),
    )
    for info in (base, {**base, "negated": (False, True, False),
                        "guards": ((1,), ())}):
        got = _nfa_rules(_check_one_nfa, info)
        assert "PLC203" in got[0]
        assert got == _nfa_rules(j_plancheck._check_one_nfa, info)


def test_entry_guard_placement_pinned():
    base = dict(
        name="q", n_elements=2, positive=(0, 1), guards=((), ()),
        t_guard=None, negated=(False, False),
        quantifiers=((1, 1), (1, -1)), entry_guards=(1,),
    )
    assert _nfa_rules(_check_one_nfa, base) == ([], [])
    for patch in (
        {"entry_guards": (0,)},
        {"entry_guards": (5,)},
        {"quantifiers": ((1, 1), (1, 1))},
        {"quantifiers": ((1, 1), (0, -1))},
    ):
        info = {**base, **patch}
        got = _nfa_rules(_check_one_nfa, info)
        assert "PLC203" in got[0], patch
        assert got == _nfa_rules(j_plancheck._check_one_nfa, info)


def test_sequence_entry_guard_compiles_and_verifies():
    cql = ("from every s1 = S[id == 1], not S[price > 50.0], "
           "s3 = S[id == 3]+ , s4 = S[id == 4] "
           "select s1.timestamp as t1, s4.timestamp as t4 insert into m")
    plan = compile_plan(cql, zoo_schemas(), plan_id="seq-entry-guard")
    (info,) = plan.artifacts[0].nfa_check_info()
    assert tuple(info["entry_guards"]) == (1,)
    assert tuple(info["quantifiers"])[1] == (1, -1)
    assert verify_plan(plan, trace=True) == []
    (ref,) = j_compile(cql, j_zoo_schemas(),
                       plan_id="seq-entry-guard").artifacts[0] \
        .nfa_check_info()
    for k in ("n_elements", "positive", "guards", "t_guard", "negated",
              "quantifiers", "entry_guards"):
        assert tuple(np.ravel(info[k]) if k != "t_guard" else [info[k]]) \
            == tuple(np.ravel(ref[k]) if k != "t_guard" else [ref[k]]), k


def test_unreachable_element_rejected():
    info = dict(
        name="q", n_elements=3, positive=(0, 1), guards=((), ()),
        t_guard=None, negated=(False, False, False),
        quantifiers=((1, 1), (1, 1), (1, 1)),
    )
    got = _nfa_rules(_check_one_nfa, info)
    assert "PLC205" in got[0]
    assert got == _nfa_rules(j_plancheck._check_one_nfa, info)


def test_donation_signature_break_rejected():
    """A state leaf consumed but not reproduced: the state a captured
    segment is bound to would go stale (PLC401)."""
    plan = _fresh("length_window_agg")
    art = plan.artifacts[0]
    orig_init = art.init_state
    art.init_state = lambda device: {
        **orig_init(device),
        "@bogus": torch.zeros(4, dtype=torch.int32, device=device),
    }
    ref = _j_fresh("length_window_agg")
    j_art = ref.artifacts[0]
    j_orig = j_art.init_state
    j_art.init_state = lambda: {**j_orig(),
                                "@bogus": jnp.zeros(4, jnp.int32)}
    got = _rules_of(plan)
    assert "PLC401" in got and got == _j_rules_of(ref)


def test_state_shape_change_across_the_step_rejected():
    """A state leaf whose shape the step changes (PLC402): the in-place
    binding of a captured segment could not reuse it."""
    plan = _fresh("length_window_agg")
    art = plan.artifacts[0]
    orig_step = art.step

    def growing_step(state, tape):
        new_state, out = orig_step(state, tape)
        new_state = dict(new_state)
        k = next(k for k, v in new_state.items()
                 if isinstance(v, torch.Tensor) and v.dim() == 0)
        new_state[k] = new_state[k].reshape(1)
        return new_state, out

    art.step = growing_step
    assert "PLC402" in _rules_of(plan)


def test_non_inert_padding_rejected():
    """An artifact emitting a phantom row for an all-invalid tape (a
    stale pad row reaching the accumulator): PLC311 in deep mode."""
    plan = _fresh("filter_select")
    art = plan.artifacts[0]
    orig_step = art.step

    def leaky_step(state, tape):
        new_state, (n, ts, cols) = orig_step(state, tape)
        return new_state, (n + 1, ts, cols)

    art.step = leaky_step
    ref = _j_fresh("filter_select")
    j_art = ref.artifacts[0]
    j_orig = j_art.step

    def j_leaky(state, tape):
        new_state, (n, ts, cols) = j_orig(state, tape)
        return new_state, (n + 1, ts, cols)

    j_art.step = j_leaky
    got = _rules_of(plan, deep=True)
    ref_rules = _j_rules_of(ref, deep=True)
    assert "PLC311" in got and "PLC311" in ref_rules
    # the leaked "+ 1" also turns the aligned mask into an integer: both
    # refuse that (PLC103), and the port's accumulator append, whose
    # torch.where wants a bool mask, cannot run it at all (PLC400)
    assert got - {"PLC400"} == ref_rules


def test_plancheck_error_renders_rule_ids():
    plan = _fresh("slot_nfa_quantified")
    plan.artifacts[0]._groups = plan.artifacts[0]._groups[:-1]
    with pytest.raises(PlanCheckError, match="PLC208"):
        verify_plan(plan, trace=False)


def test_checks_touch_no_cuda_device(monkeypatch):
    """The trace and deep tiers run on meta tensors and the CPU: the gate
    calls them off the run loop, while it may be capturing a graph."""
    def no_cuda(*a, **k):
        raise AssertionError("a plan check touched the CUDA device")

    monkeypatch.setattr(torch.cuda, "current_stream", no_cuda)
    monkeypatch.setattr(torch.cuda, "synchronize", no_cuda)
    for name in ("multiquery_stack6", "window_join", "chain_pattern"):
        assert verify_plan(_fresh(name), trace=True, deep=True) == []
