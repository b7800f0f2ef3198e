"""Shared harness of the slot-NFA parity tests (tests/test_torch_slot_nfa.py,
tests/test_torch_sequences.py): seeded streams made with numpy, handed to
the JAX package and to the port, each through its own schema, batches,
sources, ``compile_plan`` and ``Job`` (the port on the CPU, where the slot
scan runs its plain version; the JAX package's ``lax.scan`` on its CPU/XLA
path), and the rows compared."""

import numpy as np

from flink_siddhi_tpu.compiler.config import EngineConfig as JaxConfig
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.sources import BatchSource as JaxSource
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler.config import EngineConfig as TorchConfig

FIELDS = [("id", "int"), ("name", "string"), ("price", "double"),
          ("timestamp", "long")]
NAMES = ("alpha", "beta", "gamma")

PKGS = {
    "jax": (JaxSchema, JaxBatch, JaxSource, jax_compile, JaxJob, JaxConfig,
            {}),
    "torch": (fpt.StreamSchema, fpt.EventBatch, fpt.BatchSource,
              fpt.compile_plan, fpt.Job, TorchConfig, {"device": "cpu"}),
}


def columns(n_events, n_ids, seed, step_ms=20, t0=1000, price_step=None):
    """One stream's columns: id uniform in [0, n_ids), a name drawn from
    NAMES, price uniform x 100 (or ``price_step`` * index: a ramp), and
    timestamp ``t0 + i * step_ms``."""
    rng = np.random.default_rng(seed)
    price = (np.arange(n_events) * float(price_step) if price_step
             else rng.random(n_events) * 100.0)
    return {
        "id": rng.integers(0, n_ids, n_events).astype(np.int32),
        "name": rng.integers(0, len(NAMES), n_events),
        "price": price,
        "timestamp": t0 + step_ms * np.arange(n_events, dtype=np.int64),
    }


def run(pkg, cql, streams, batch, out, fields=None, **config):
    """Run ``cql`` in one package over ``streams`` ({stream id: columns},
    every stream with ``fields``, default FIELDS), micro-batches of
    ``batch`` events a stream. Returns (rows with timestamps, job)."""
    Schema, Batch, Source, compile_plan, Job, Config, kw = PKGS[pkg]
    fields = fields or FIELDS
    schemas, sources = {}, []
    for sid, cols in streams.items():
        schema = Schema(fields)
        schemas[sid] = schema
        data = dict(cols)
        if "name" in data:
            table = schema.string_tables["name"]
            codes = np.array([table.intern(n) for n in NAMES], np.int32)
            data["name"] = codes[data["name"]]
        n = len(data["timestamp"])
        batches = [
            Batch(sid, schema, {k: v[s:s + batch] for k, v in data.items()},
                  data["timestamp"][s:s + batch])
            for s in range(0, n, batch)
        ]
        sources.append(Source(sid, schema, iter(batches)))
    plan = compile_plan(cql, schemas, plan_id="p", config=Config(**config))
    job = Job([plan], sources, batch_size=batch, time_mode="processing",
              **kw)
    job.run()
    return job.results_with_ts(out), job


def assert_same_rows(cql, streams, batch, out="o", min_rows=1, rtol=0.0,
                     fields=None, **config):
    """The port's rows equal the JAX package's: timestamps, ints and
    strings exactly, float values bitwise (they are copies of float32
    columns), or within ``rtol`` where a projection computes. Returns the
    rows and both jobs."""
    ref, jjob = run("jax", cql, streams, batch, out, fields, **config)
    got, tjob = run("torch", cql, streams, batch, out, fields, **config)
    assert len(ref) >= min_rows, f"the stream produced {len(ref)} rows"
    if rtol == 0.0:
        assert got == ref
    else:
        assert len(got) == len(ref)
        for (tg, rg), (tr, rr) in zip(got, ref):
            assert tg == tr and len(rg) == len(rr)
            for a, b in zip(rg, rr):
                if isinstance(b, float) and isinstance(a, float):
                    assert abs(a - b) <= rtol * abs(b), (rg, rr)
                else:
                    assert a == b, (rg, rr)
    return ref, jjob, tjob


def artifact(job):
    (art,) = job._plans["p"].plan.artifacts
    return art
