"""Shared helpers of the window tests of the torch port (not a test module).

One stream shape for every window test: ``S (id int, name string, price
double, vol int, timestamp long)``, made with numpy from a seed — id uniform
in [0, n_ids), name one of three, price uniform in [0, 100), vol an integer
in [-1000, 1000), timestamp 1000 + i * step_ms. Each package gets the same
columns through its own schema, batches, source, ``compile_plan`` and
``Job`` (the port on the CPU).

``assert_rows`` holds the port's rows to the JAX package's: the same
timestamps in the same order, keys, counts, integer sums and min/max
exactly, float32 sums, averages and deviations within rtol 1e-5. Where a
case's data makes the reference's own float32 error larger than that, the
column is held to a float64 numpy oracle instead (``window_oracle``): the
port's largest error against it may be at most twice the reference's.
"""

from typing import Callable, Dict, List, Optional

import numpy as np

from flink_siddhi_tpu.compiler.config import EngineConfig as JaxConfig
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.replay import ResidentReplay as JaxReplay
from flink_siddhi_tpu.runtime.sources import BatchSource as JaxSource
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt

FIELDS = [("id", "int"), ("name", "string"), ("price", "double"),
          ("vol", "int"), ("timestamp", "long")]
NAMES = ("alpha", "beta", "gamma")
PKGS = {
    "jax": (JaxSchema, JaxBatch, JaxSource, jax_compile, JaxJob, JaxConfig,
            JaxReplay, {}),
    "torch": (fpt.StreamSchema, fpt.EventBatch, fpt.BatchSource,
              fpt.compile_plan, fpt.Job, fpt.EngineConfig,
              fpt.ResidentReplay, {"device": "cpu"}),
}


def stream(n_events: int, batch: int, n_ids: int, seed: int = 7,
           step_ms: int = 1, vol=None) -> List[Dict[str, np.ndarray]]:
    """The columns of each micro-batch (``vol(rng, m)`` overrides vol)."""
    rng = np.random.default_rng(seed)
    out = []
    for start in range(0, n_events, batch):
        m = min(batch, n_events - start)
        out.append({
            "id": rng.integers(0, n_ids, m).astype(np.int32),
            "name": rng.integers(0, len(NAMES), m),
            "price": rng.random(m) * 100.0,
            "vol": (rng.integers(-1000, 1000, m) if vol is None
                    else vol(rng, m)).astype(np.int32),
            "ts": 1000 + step_ms * (start + np.arange(m, dtype=np.int64)),
        })
    return out


def flat(data) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([d[k] for d in data]) for k in data[0]}


def batches(pkg: str, data):
    Schema, Batch = PKGS[pkg][:2]
    schema = Schema(FIELDS)
    codes = np.array(
        [schema.string_tables["name"].intern(n) for n in NAMES], np.int32
    )
    return schema, [
        Batch("S", schema, {"id": d["id"], "name": codes[d["name"]],
                            "price": d["price"], "vol": d["vol"],
                            "timestamp": d["ts"]}, d["ts"])
        for d in data
    ]


def job(pkg: str, cql: str, data, batch: int, retain: bool = True,
        **config):
    _, _, Source, compile_plan, Job, Config, _, kw = PKGS[pkg]
    schema, bs = batches(pkg, data)
    plan = compile_plan(cql, {"S": schema}, plan_id="p",
                        config=Config(**config))
    return Job([plan], [Source("S", schema, iter(bs))], batch_size=batch,
               time_mode="processing", retain_results=retain, **kw)


def run(pkg: str, cql: str, data, batch: int, out: str = "out",
        resident: bool = False, **config):
    """Rows (ts, row) of ``cql`` over ``data`` in one package, streaming
    or through ``ResidentReplay``; returns (rows, job)."""
    j = job(pkg, cql, data, batch, **config)
    if resident:
        PKGS[pkg][6](j).execute()
    else:
        j.run()
    return j.results_with_ts(out), j


def assert_rows(got, ref, oracle: Optional[Dict[int, np.ndarray]] = None,
                min_rows: int = 1):
    """The port's rows ``got`` against the reference's ``ref`` (see the
    module docstring); ``oracle`` maps a float column to its float64
    values, row by row."""
    assert len(ref) >= min_rows, "the stream produced too few rows"
    assert len(got) == len(ref)
    assert [t for t, _ in got] == [t for t, _ in ref]
    for c in range(len(ref[0][1])):
        g = [r[c] for _, r in got]
        e = [r[c] for _, r in ref]
        if not any(isinstance(v, float) for v in e):
            assert g == e, f"column {c}"
            continue
        g, e = np.asarray(g, np.float64), np.asarray(e, np.float64)
        if np.allclose(g, e, rtol=1e-5):
            continue
        assert oracle is not None and c in oracle, (
            f"column {c}: max relative difference "
            f"{np.max(np.abs(g - e) / np.maximum(np.abs(e), 1e-30))}"
        )
        want = oracle[c]
        ref_err = np.max(np.abs(e - want))
        port_err = np.max(np.abs(g - want))
        assert port_err <= 2 * ref_err, (c, port_err, ref_err)


def window_oracle(f: Dict[str, np.ndarray], accept: np.ndarray,
                  members: Callable, value: Callable,
                  group: bool = True) -> np.ndarray:
    """Per accepted event, in order, ``value(w)`` over its window ``w``
    (indices into the flat stream): ``members(k, idx)`` is the window of
    the k-th accepted event among the accepted indices ``idx``, narrowed
    to the event's own group when ``group``."""
    idx = np.nonzero(accept)[0]
    out = np.empty(len(idx))
    for k, i in enumerate(idx):
        w = members(k, idx)
        if group:
            w = w[f["id"][w] == f["id"][i]]
        out[k] = value(w)
    return out


def last(n: int) -> Callable:
    """Window members of a length-n window."""
    return lambda k, idx: idx[max(0, k - n + 1):k + 1]


def within(f, span: int, n: Optional[int] = None) -> Callable:
    """Window members of a time window of ``span`` ms (of at most n
    events)."""
    def members(k, idx):
        w = idx[:k + 1] if n is None else idx[max(0, k - n + 1):k + 1]
        return w[f["ts"][w] > f["ts"][idx[k]] - span]
    return members


def upto(k, idx):
    """Window members of cumulative aggregation: every event so far."""
    return idx[:k + 1]


def f32(x: np.ndarray) -> np.ndarray:
    """Values as the device holds them (float32), in float64."""
    return x.astype(np.float32).astype(np.float64)


def stats(f, col: str):
    """sum / avg / stddev of ``col`` over a window, float64."""
    v = f32(f[col])

    def s(w):
        return v[w].sum()

    def avg(w):
        return v[w].mean()

    def sd(w):
        m = v[w].mean()
        return np.sqrt(max((v[w] ** 2).mean() - m * m, 0.0))

    return s, avg, sd
