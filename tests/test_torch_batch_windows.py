"""Batch windows, expired-event output and ``#window.delay`` in the torch
port, against the JAX package.

Each case runs one SiddhiQL query over the same seeded numpy stream in both
packages (the port on the CPU, ``tests/torch_windows_common.py``) and holds
the rows to the reference's: keys, timestamps, emission order, counts,
integer sums and min/max exactly, float32 sums and averages within rtol
1e-5 (a batch cell's float sum runs in a fixed order in the port, a sorted
float64 scan, and in event order in the reference).

Covered: ``lengthBatch``, ``timeBatch`` (with a projected non-aggregate
attribute, the cell's last event), ``externalTimeBatch`` and ``cron``
windows with group-by and ``having``; ``insert expired events`` over
length and time windows; ``#window.delay``; the end-of-stream flush of
time-batch, cron and expired time windows (rows before and after it); the
same plans through ``ResidentReplay`` with a collector and counts-only
(``rerun``); the drain cadence a batch window's group grid sets; the cron
window's host-computed window-id column on the wire, bit-equal to the
reference's; and batch and expired window state carried from the JAX plan
into the port mid-stream.
"""

import jax
import numpy as np
import pytest
import torch

from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.tape import build_tape as jax_build_tape
from flink_siddhi_tpu.runtime.tape import build_wire_tape as jax_wire

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler.window import (
    BatchWindowArtifact,
    ExpiredWindowArtifact,
)
from flink_siddhi_tpu_torch.runtime.replay import ResidentReplay
from flink_siddhi_tpu_torch.runtime.tape import build_tape as torch_build_tape
from flink_siddhi_tpu_torch.runtime.tape import build_wire_tape as torch_wire

from torch_windows_common import assert_rows, batches, job, run, stream

torch.set_num_threads(2)

# name -> (cql, (n_events, batch, n_ids, step_ms), artifact class)
CASES = {
    "length_batch_groupby_having": (
        "from S#window.lengthBatch(500) select id, count() as c, "
        "sum(price) as s, max(vol) as hi group by id having c > 20 "
        "insert into out",
        (6000, 2048, 20, 1), BatchWindowArtifact,
    ),
    "length_batch_no_group": (
        "from S[vol > 0]#window.lengthBatch(150) select count() as c, "
        "avg(price) as a, min(vol) as lo insert into out",
        (5000, 1024, 20, 1), BatchWindowArtifact,
    ),
    "time_batch_groupby": (
        "from S#window.timeBatch(700 milliseconds) select id, name, "
        "sum(price) as s, min(vol) as lo, avg(vol) as a, "
        "stddev(vol) as sd group by id insert into out",
        (6000, 2048, 20, 1), BatchWindowArtifact,
    ),
    "time_batch_having": (
        "from S[price > 10.0]#window.timeBatch(1 sec) select id, "
        "count() as c, sum(vol) as v group by id having v > 0 "
        "insert into out",
        (6000, 2048, 10, 1), BatchWindowArtifact,
    ),
    "external_time_batch": (
        "from S#window.externalTimeBatch(timestamp, 400 milliseconds) "
        "select sum(price) as s, count() as c, max(price) as hi "
        "insert into out",
        (5000, 2048, 20, 1), BatchWindowArtifact,
    ),
    "cron_groupby": (
        "from S#window.cron('*/2 * * * * ?') select id, count() as c, "
        "sum(vol) as v group by id insert into out",
        (6000, 1024, 8, 3), BatchWindowArtifact,
    ),
    "expired_length": (
        "from S[id < 10]#window.length(40) select id, price, vol "
        "insert expired events into out",
        (5000, 1024, 20, 1), ExpiredWindowArtifact,
    ),
    "expired_time": (
        "from S#window.time(150 milliseconds) select id, price "
        "insert expired events into out",
        (5000, 2048, 20, 1), ExpiredWindowArtifact,
    ),
    "delay": (
        "from S[vol > 500]#window.delay(60 milliseconds) "
        "select id, name, price insert into out",
        (5000, 2048, 20, 1), ExpiredWindowArtifact,
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_and_expired_rows_match_jax(case):
    cql, (n, batch, n_ids, step), cls = CASES[case]
    data = stream(n, batch, n_ids, seed=len(case), step_ms=step)
    ref, jjob = run("jax", cql, data, batch)
    got, tjob = run("torch", cql, data, batch)
    assert isinstance(tjob._plans["p"].plan.artifacts[0], cls)
    assert_rows(got, ref, min_rows=10)
    # the same drain cadence: a batch window's block is its whole grid
    assert tjob._drain_hints == jjob._drain_hints


FLUSHED = ["time_batch_groupby", "cron_groupby", "expired_time", "delay"]


def _rows_around_flush(pkg, cql, data, batch):
    j = job(pkg, cql, data, batch)
    while not j.finished:
        j.run_cycle()
    before = j.results_with_ts("out")
    j.flush()
    return before, j.results_with_ts("out")[len(before):]


@pytest.mark.parametrize("case", FLUSHED)
def test_end_of_stream_flush_matches_jax(case):
    cql, (n, batch, n_ids, step), _ = CASES[case]
    data = stream(n, batch, n_ids, seed=11, step_ms=step)
    jb, ja = _rows_around_flush("jax", cql, data, batch)
    tb, ta = _rows_around_flush("torch", cql, data, batch)
    assert_rows(tb, jb, min_rows=10)
    # the flush carries the last window (or the pending expiries) out
    assert_rows(ta, ja, min_rows=1)


@pytest.mark.parametrize("case", ["time_batch_groupby", "expired_time",
                                  "length_batch_groupby_having"])
def test_resident_replay_matches_streaming_and_jax(case):
    cql, (n, batch, n_ids, step), _ = CASES[case]
    data = stream(n, batch, n_ids, seed=2, step_ms=step)
    ref, _ = run("jax", cql, data, batch, resident=True)
    got, _ = run("torch", cql, data, batch, resident=True)
    streamed, _ = run("torch", cql, data, batch)
    assert_rows(got, ref, min_rows=10)
    assert got == streamed
    # counts-only: run + flush, then reruns count the same rows again
    j = job("torch", cql, data, batch, retain=False)
    rep = ResidentReplay(j)
    rep.stage()
    rep.run()
    j.flush()
    assert j.emitted_counts["out"] == len(got)
    rep.rerun()
    assert j.emitted_counts["out"] == 2 * len(got)


def test_batch_grid_grows_between_segments():
    # keys keep arriving: the group table re-buckets 64 -> 128 -> 256 on
    # the host-known encoder size, in the streaming job between steps and
    # once after staging in the resident replay
    cql = ("from S#window.lengthBatch(256) select id, count() as c, "
           "sum(vol) as v group by id insert into out")
    data = stream(4096, 512, 200, seed=9)
    ref, _ = run("jax", cql, data, 512)
    got, tjob = run("torch", cql, data, 512)
    res, rjob = run("torch", cql, data, 512, resident=True)
    assert got == ref == res
    for j in (tjob, rjob):
        assert tuple(j._plans["p"].states["query_0"]["cnt"].shape) == (256,)


def test_cron_window_ids_on_the_wire_match_jax():
    """The cron window's per-event window id (a host-computed int column,
    ``HostPred.dtype``) ships narrowed like any int column, bit-equal to
    the reference's wire tape."""
    cql = CASES["cron_groupby"][0]
    data = stream(3000, 1000, 8, seed=4, step_ms=3)
    wires = {}
    for pkg, wire in (("jax", jax_wire), ("torch", torch_wire)):
        schema, bs = batches(pkg, data)
        compile_plan = jax_compile if pkg == "jax" else fpt.compile_plan
        plan = compile_plan(cql, {"S": schema})
        (hp,) = plan.spec.host_preds
        assert hp.refs == ("@ts",) and np.dtype(hp.dtype) == np.int32
        kinds = {}
        wires[pkg] = [wire(plan.spec, [b], 1000, kinds)[0] for b in bs]
    for jw, tw in zip(wires["jax"], wires["torch"]):
        assert tw.kinds == jw.kinds
        assert dict(tw.kinds)["@cron:query_0"] == "i8"
        assert tw.ts_kind == jw.ts_kind
        assert sorted(tw.cols) == sorted(jw.cols)
        for k in jw.cols:
            j, t = np.asarray(jw.cols[k]), np.asarray(tw.cols[k])
            assert j.dtype == t.dtype and np.array_equal(j, t), k


@pytest.mark.parametrize("case", ["time_batch_groupby", "expired_time"])
def test_state_carried_from_jax_into_port(case):
    """The JAX plan steps two batches; its state (the open window's
    accumulators and seen/batch/t0, or the expired ring with its count and
    overflow) and its encoder seed the port's plan; both step the rest."""
    cql, (_, batch, n_ids, step), _ = CASES[case]
    data = stream(4 * batch, batch, n_ids, seed=6, step_ms=step)
    (js, jb), (ts, tb) = batches("jax", data), batches("torch", data)
    jplan = jax_compile(cql, {"S": js})
    tplan = fpt.compile_plan(cql, {"S": ts})
    jstep = jax.jit(jplan.step_acc)
    jst = jplan.init_state()
    for b in jb[:2]:
        tape, _ = jax_build_tape(jplan.spec, [b], 1000)
        jst, _ = jstep(jplan.grow_state(jst), jplan.init_acc(), tape)
    carried = jax.device_get(jst)
    encoders = {e.out_key: e.encoder.state_dict() for e in jplan.spec.encoded}
    tst = fpt.state_from_numpy(tplan, carried, "cpu", encoders=encoders)
    jrows, trows = [], []
    for j, t in zip(jb[2:], tb[2:]):
        jt, _ = jax_build_tape(jplan.spec, [j], 1000)
        tt = torch_build_tape(tplan.spec, [t], 1000).to(torch.device("cpu"))
        jst, jacc = jstep(jplan.grow_state(jst), jplan.init_acc(), jt)
        tst, tacc = tplan.step_acc(tplan.grow_state(tst),
                                   tplan.init_acc("cpu"), tt)
        for plan, acc, rows in ((jplan, jacc, jrows),
                                (tplan, {k: v.numpy() for k, v in
                                         tacc.items()}, trows)):
            counts = np.asarray(acc["meta"])[0]
            if counts.max():
                out = plan.drain_decode(
                    counts, np.asarray(acc["buf"])[:, :counts.max()])
                rows.extend(out["query_0"][0][1])
    assert_rows(trows, jrows, min_rows=10)
    jfinal = jax.device_get(jst)["query_0"]
    tfinal = fpt.compiler.plan.state_to_numpy(tst)["query_0"]
    flat_j = jax.tree_util.tree_leaves_with_path(jfinal)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(tfinal))
    for path, leaf in flat_j:
        sub = tfinal
        for p in path:
            sub = sub[p.key]
        if np.asarray(leaf).dtype == np.float32:
            assert np.allclose(sub, leaf, rtol=1e-5), path
        else:
            assert np.array_equal(sub, np.asarray(leaf)), path
