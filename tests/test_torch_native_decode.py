"""The port's native column decoder (``flink_siddhi_tpu_torch/native``) and
its byte sources, on the CPU.

* The 13 cases of ``tests/test_native_decode.py`` against the port (the
  end-to-end ones through the port's ``Job`` on ``device="cpu"``, their
  rows equal to the JAX package's).
* Parity: on the same seeded bytes, the port's decoder gives the JAX
  package's columns, validity and string codes, on the native path and
  on the pure-Python path (the decoder's plain version), each against
  both of the reference's paths.
* The build: ``fast_decode.cpp`` is an exact copy (``test_torch_host``);
  the port builds it into ``build/torch_native/``, and two processes
  building into one empty directory at once both load a whole library.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flink_siddhi_tpu import native as jax_native
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime import sources as jax_sources
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema
from flink_siddhi_tpu.schema.strings import StringTable as JaxStringTable

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch import native
from flink_siddhi_tpu_torch.native import (
    KIND_BOOL,
    KIND_DOUBLE,
    KIND_INT,
    KIND_STRING,
    ColumnDecoder,
    available,
)
from flink_siddhi_tpu_torch.runtime.sources import (
    BatchSource,
    JsonLinesSource,
)
from flink_siddhi_tpu_torch.schema.strings import StringTable

torch.set_num_threads(2)

_REPO = Path(__file__).resolve().parent.parent
FIELDS4 = [("id", "int"), ("name", "string"), ("price", "double"),
           ("timestamp", "long")]


def make_decoder():
    table = StringTable()
    fields = [
        ("id", KIND_INT, None),
        ("name", KIND_STRING, table),
        ("price", KIND_DOUBLE, None),
    ]
    return ColumnDecoder(fields), table


def python_path(dec):
    """Force a decoder onto its pure-Python path (the plain version)."""
    dec._lib = None
    dec._mirrors = []
    return dec


def sample_lines(n=100):
    recs = [
        {"id": i, "name": f"n{i % 5}", "price": i * 0.5, "extra": [1, 2]}
        for i in range(n)
    ]
    return (
        "\n".join(json.dumps(r) for r in recs).encode() + b"\n",
        recs,
    )


def _job_rows(pkg, cql, out, make_src, batch_size=64):
    """Rows of ``cql`` over the byte source ``make_src(pkg)`` through the
    port's Job on the CPU, or the JAX package's Job."""
    if pkg == "torch":
        schema = fpt.StreamSchema(list(FIELDS4))
        job = fpt.Job([fpt.compile_plan(cql, {"S": schema})],
                      [make_src(fpt, schema)], batch_size=batch_size,
                      device="cpu")
    else:
        schema = JaxSchema(list(FIELDS4))
        job = JaxJob([jax_compile(cql, {"S": schema})],
                     [make_src(jax_sources, schema)], batch_size=batch_size)
    job.run()
    return job.results_with_ts(out)


# -- the reference's cases, against the port --------------------------------

def test_native_available():
    # the environment ships g++; the port's copy must build and load
    assert available(), "native decode library failed to build/load"
    assert Path(native.library_path()).parent == \
        _REPO / "build" / "torch_native"
    assert os.path.exists(native.library_path())


def test_json_decode_basic():
    dec, table = make_decoder()
    data, recs = sample_lines(100)
    cols, valid, n = dec.decode_json(data, 200)
    assert n == 100 and valid.all()
    assert cols[0].tolist() == [r["id"] for r in recs]
    assert [table.value(c) for c in cols[1]] == [r["name"] for r in recs]
    np.testing.assert_allclose(cols[2], [r["price"] for r in recs])


def test_json_escapes_and_unicode():
    dec, table = make_decoder()
    line = (
        b'{"id": 1, "name": "a\\"b\\\\c\\nd\\u00e9\\ud83d\\ude00", '
        b'"price": -2.5e2}\n'
    )
    cols, valid, n = dec.decode_json(line, 10)
    assert n == 1 and valid[0]
    assert table.value(cols[1][0]) == 'a"b\\c\ndé\U0001F600'
    assert cols[2][0] == -250.0


def test_json_missing_fields_and_null():
    dec, table = make_decoder()
    data = (
        b'{"id": 7}\n'
        b'{"name": null, "price": 1.5, "id": 8}\n'
    )
    cols, valid, n = dec.decode_json(data, 10)
    assert n == 2 and valid.all()
    assert cols[0].tolist() == [7, 8]
    assert table.value(cols[1][0]) == "" and table.value(cols[1][1]) == ""
    assert cols[2].tolist() == [0.0, 1.5]


def test_json_malformed_rows_flagged():
    dec, _ = make_decoder()
    data = b'{"id": 1}\nnot json\n{"id": 3}\n{"id": oops}\n'
    cols, valid, n = dec.decode_json(data, 10)
    assert n == 4
    assert valid.tolist() == [1, 0, 1, 0]
    assert cols[0][0] == 1 and cols[0][2] == 3


def test_interner_codes_match_precompiled_constants():
    # query compilation interns constants FIRST; native decode must reuse
    # those codes, and newly discovered strings must round-trip back
    dec, table = make_decoder()
    pre = table.intern("n3")  # as a query predicate constant would
    data, recs = sample_lines(20)
    cols, valid, n = dec.decode_json(data, 30)
    codes = {table.value(c): int(c) for c in cols[1]}
    assert codes["n3"] == pre
    for name, code in codes.items():
        assert table.lookup(name) == code


def test_python_fallback_equivalence():
    data, recs = sample_lines(50)
    native_dec, t1 = make_decoder()
    assert native_dec.native
    py_dec, t2 = make_decoder()
    python_path(py_dec)
    a_cols, a_valid, a_n = native_dec.decode_json(data, 100)
    b_cols, b_valid, b_n = py_dec.decode_json(data, 100)
    assert a_n == b_n and a_valid.tolist() == b_valid.tolist()
    assert a_cols[0].tolist() == b_cols[0].tolist()
    np.testing.assert_allclose(a_cols[2], b_cols[2])
    assert [t1.value(c) for c in a_cols[1]] == [
        t2.value(c) for c in b_cols[1]
    ]


def test_csv_decode():
    dec, table = make_decoder()
    data = b'1,alpha,0.5\n2,"beta,x",1.5\n3,alpha,2.5\nbad,row,zz\n'
    cols, valid, n = dec.decode_csv(data, 10)
    assert n == 4
    assert valid.tolist() == [1, 1, 1, 0]
    assert cols[0][:3].tolist() == [1, 2, 3]
    assert table.value(cols[1][1]) == "beta,x"
    assert cols[2][:3].tolist() == [0.5, 1.5, 2.5]


def test_json_lines_source_e2e(tmp_path):
    # file -> native decode -> CEP filter query -> typed results
    path = tmp_path / "events.jsonl"
    with open(path, "w") as f:
        for i in range(200):
            f.write(json.dumps({"id": i % 4, "name": f"n{i % 3}",
                                "price": float(i),
                                "timestamp": 1000 + i}) + "\n")
    cql = "from S[id == 2] select name, price insert into out"

    def make_src(mod, schema):
        return mod.JsonLinesSource("S", schema, str(path),
                                   ts_field="timestamp", chunk_bytes=512)

    rows = _job_rows("torch", cql, "out", make_src)
    assert len(rows) == 50
    assert rows[0][1] == ("n2", 2.0)
    assert rows == _job_rows("jax", cql, "out", make_src)


def test_csv_source_e2e(tmp_path):
    path = tmp_path / "events.csv"
    with open(path, "w") as f:
        f.write("id,name,price,timestamp\n")
        for i in range(100):
            f.write(f"{i % 4},n{i % 3},{float(i)},{1000 + i}\n")
    cql = "from S[price > 90.0] select id, price insert into big"

    def make_src(mod, schema):
        return mod.CsvSource("S", schema, str(path), header=True,
                             ts_field="timestamp")

    rows = _job_rows("torch", cql, "big", make_src)
    assert len(rows) == 9
    assert rows == _job_rows("jax", cql, "big", make_src)


def test_csv_bool_literals_both_decoders():
    def make_bool_decoder():
        return ColumnDecoder([("id", KIND_INT, None),
                              ("flag", KIND_BOOL, None)])

    data = (
        b"1,true\n2,False\n3,TRUE\n4,0\n5,1\n6,maybe\n"
        b"+7,true \n 8 , FALSE\n"  # signs/whitespace: int()/float() parity
    )
    native_dec = make_bool_decoder()
    py_dec = python_path(make_bool_decoder())
    for dec in (native_dec, py_dec):
        cols, valid, n = dec.decode_csv(data, 10)
        assert n == 8
        assert valid.tolist() == [1, 1, 1, 1, 1, 0, 1, 1], dec.native
        assert cols[0][6:8].tolist() == [7, 8], dec.native
        assert (
            cols[1][:5].tolist() + cols[1][6:8].tolist()
        ) == [1, 0, 1, 0, 1, 1, 0], dec.native


def test_source_allowed_lateness():
    # bounded-disorder input: with allowed_lateness_ms the watermark holds
    # back, so a later chunk carrying older timestamps still reorders
    schema = fpt.StreamSchema([("id", "int"), ("timestamp", "long")])
    lines = [
        {"id": 0, "timestamp": 1000},
        {"id": 1, "timestamp": 1200},
        {"id": 2, "timestamp": 1100},
        {"id": 3, "timestamp": 1300},
    ]
    raw = "\n".join(json.dumps(r) for r in lines).encode() + b"\n"
    src = JsonLinesSource("S", schema, io.BytesIO(raw), ts_field="timestamp",
                          chunk_bytes=40, allowed_lateness_ms=200)
    batch, wm, done = src.poll(10)
    assert wm == int(batch.timestamps.max()) - 200


def test_sink_streams_skip_retention_when_disabled():
    schema = fpt.StreamSchema([("id", "int"), ("timestamp", "long")])
    ids = np.arange(100, dtype=np.int64) % 4
    ts = 1000 + np.arange(100, dtype=np.int64)
    batch = fpt.EventBatch("S", schema, {"id": ids, "timestamp": ts}, ts)
    plan = fpt.compile_plan(
        "from S[id == 2] select id, timestamp insert into out", {"S": schema})
    got = []
    job = fpt.Job([plan], [BatchSource("S", schema, iter([batch]))],
                  batch_size=64, retain_results=False, device="cpu")
    job.add_sink("out", lambda ts, row: got.append(row))
    job.run()
    assert len(got) == 25
    assert job.results("out") == []
    assert job.emitted_counts["out"] == 25


# -- parity with the JAX package's decoder -----------------------------------

def _seeded_json(seed, n=300):
    """JSON lines from ``seed``: ints past int32, doubles in exponent
    form, unicode and escaped names, nulls, missing fields, malformed
    lines and wrong types."""
    rng = np.random.default_rng(seed)
    names = ["alpha", "beta", "éè", "q\"uote", "tab\there", "x" * 40,
             "", "n3"]
    lines = []
    for i in range(n):
        r = {"id": int(rng.integers(-2**40, 2**40)),
             "name": names[int(rng.integers(len(names)))],
             "price": float(rng.normal() * 10 ** int(rng.integers(-5, 9)))}
        pick = rng.random()
        if pick < 0.05:
            r["name"] = None
        elif pick < 0.1:
            del r["price"]
        elif pick < 0.13:
            r["id"] = "12"  # a quoted number: invalid row
        line = json.dumps(r)
        if rng.random() < 0.04:
            line = line[: len(line) // 2]  # truncated: malformed
        lines.append(line)
    return ("\n".join(lines) + "\n").encode()


def _seeded_csv(seed, n=300):
    rng = np.random.default_rng(seed)
    names = ["alpha", '"beta,x"', "gamma", "", "n3"]
    rows = []
    for i in range(n):
        cells = [str(int(rng.integers(-2**40, 2**40))),
                 names[int(rng.integers(len(names)))],
                 repr(float(rng.normal() * 1e3)),
                 ["true", "False", "0", "1", "maybe"][int(rng.integers(5))]]
        if rng.random() < 0.05:
            cells[2] = "zz"
        rows.append(",".join(cells))
    return ("\n".join(rows) + "\r\n").encode()


def _decoders(which):
    """(port decoder, its table, reference decoder, its table); both on
    the native path or both on the Python path, with the same query
    constant interned first."""
    port_t, ref_t = StringTable(), JaxStringTable()
    port = ColumnDecoder([("id", KIND_INT, None),
                          ("name", KIND_STRING, port_t),
                          ("price", KIND_DOUBLE, None),
                          ("flag", KIND_BOOL, None)])
    ref = jax_native.ColumnDecoder([
        ("id", jax_native.KIND_INT, None),
        ("name", jax_native.KIND_STRING, ref_t),
        ("price", jax_native.KIND_DOUBLE, None),
        ("flag", jax_native.KIND_BOOL, None)])
    for t in (port_t, ref_t):
        t.intern("n3")
    if which == "python":
        python_path(port)
        python_path(ref)
    else:
        assert port.native and ref.native
    return port, port_t, ref, ref_t


def _assert_same_decode(a, b):
    (a_cols, a_valid, a_n), (b_cols, b_valid, b_n) = a, b
    assert a_n == b_n
    assert a_valid.tolist() == b_valid.tolist()
    for x, y in zip(a_cols, b_cols):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("which", ["native", "python"])
@pytest.mark.parametrize("seed", [3, 11])
def test_json_columns_and_codes_equal_the_reference(which, seed):
    port, port_t, ref, ref_t = _decoders(which)
    data = _seeded_json(seed)
    # two decodes through the same decoders: the second reuses the codes
    # the first interned
    for chunk in (data, _seeded_json(seed + 100)):
        _assert_same_decode(port.decode_json(chunk, 400),
                            ref.decode_json(chunk, 400))
    assert port_t._values == ref_t._values


@pytest.mark.parametrize("which", ["native", "python"])
@pytest.mark.parametrize("seed", [5, 17])
def test_csv_columns_and_codes_equal_the_reference(which, seed):
    port, port_t, ref, ref_t = _decoders(which)
    data = _seeded_csv(seed)
    _assert_same_decode(port.decode_csv(data, 400),
                        ref.decode_csv(data, 400))
    assert port_t._values == ref_t._values


@pytest.mark.parametrize("seed", [3, 5])
def test_native_and_python_paths_agree_on_seeded_bytes(seed):
    nat, nat_t, _, _ = _decoders("native")
    py, py_t, _, _ = _decoders("python")
    data = _seeded_json(seed)
    a, b = nat.decode_json(data, 400), py.decode_json(data, 400)
    assert a[1].tolist() == b[1].tolist() and a[2] == b[2]
    ok = a[1].astype(bool)
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x[ok], y[ok])
    # codes agree where the rows are valid (an invalid row's cells are
    # the decoders' own business)
    assert [nat_t.value(c) for c in a[0][1][ok]] == \
        [py_t.value(c) for c in b[0][1][ok]]


def test_byte_source_batches_equal_the_reference(tmp_path):
    """JsonLinesSource and CsvSource: the same EventBatches (columns,
    timestamps) and watermarks as the JAX package's, chunk by chunk."""
    path = tmp_path / "e.jsonl"
    rng = np.random.default_rng(9)
    with open(path, "w") as f:
        for i in range(500):
            f.write(json.dumps({"id": int(rng.integers(0, 5)),
                                "name": f"n{int(rng.integers(0, 7))}",
                                "price": float(rng.random()),
                                "timestamp": 1000 + i}) + "\n")
    csv = tmp_path / "e.csv"
    with open(csv, "w") as f:
        f.write("id,name,price,timestamp\n")
        for i in range(500):
            f.write(f"{i % 5},n{i % 7},{i * 0.25},{1000 + i}\n")
    for make in (
        lambda mod, s: mod.JsonLinesSource("S", s, str(path),
                                           ts_field="timestamp",
                                           chunk_bytes=700),
        lambda mod, s: mod.CsvSource("S", s, str(csv), header=True,
                                     ts_field="timestamp", chunk_bytes=300),
    ):
        a = make(fpt, fpt.StreamSchema(list(FIELDS4)))
        b = make(jax_sources, JaxSchema(list(FIELDS4)))
        polls = 0
        while True:
            (ba, wa, da), (bb, wb, db) = a.poll(64), b.poll(64)
            assert (wa, da) == (wb, db)
            assert (ba is None) == (bb is None)
            if ba is not None:
                np.testing.assert_array_equal(ba.timestamps, bb.timestamps)
                for k in ba.columns:
                    np.testing.assert_array_equal(ba.columns[k],
                                                  bb.columns[k])
            assert a.state_dict() == b.state_dict()
            polls += 1
            if da:
                break
        assert polls > 5


def test_two_processes_building_at_once_both_load_a_whole_library(
        tmp_path):
    """Each process compiles to a temporary name and moves it into place
    with os.replace: neither can load a half-written library."""
    code = (
        "import sys\n"
        "import flink_siddhi_tpu_torch.native as n\n"
        "n.BUILD_DIR = sys.argv[1]\n"
        "assert n.available(), 'no library'\n"
        "dec = n.ColumnDecoder([('id', n.KIND_INT, None)])\n"
        "cols, valid, k = dec.decode_json(b'{\"id\": 41}\\n', 4)\n"
        "assert dec.native and k == 1 and cols[0].tolist() == [41]\n"
        "print('LOADED', n.library_path())\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "LOADED" in out
    libs = sorted(os.listdir(tmp_path))
    assert len(libs) == 1 and libs[0].startswith("libfastdecode-"), libs
