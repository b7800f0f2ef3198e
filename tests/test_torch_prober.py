"""The out-of-process side-channel prober (``telemetry/prober.py``, an
exact copy of the reference's) against the port's Job, on the CPU.

The reference's cases of ``tests/test_prober.py`` on a port Job behind a
``SocketLineSource``: the prober is a separate OS process (by pid), its
sentinel events go through the real socket ingest, decode, step, drain
and sink, and every probe is accounted for (received or listed lost); a
probe that never matches comes back lost instead of hanging the run. The
port's per-event tracer (``sample_every = 1``) completes a trace for
every received probe. The reference's CPU lane also holds the prober's
p99 against the traced p99 within max(3x, 250 ms); on this port's CPU
lane that is a wall-clock bound, left to the card (``chip_smoke.py``
phase 8k, T2): these tests assert counts only.
"""

import os
import socket
import time

from flink_siddhi_tpu_torch.telemetry.prober import (
    ProbeReport,
    SideChannelProber,
)

from tests.torch_telemetry_common import TORCH, schema

MAGIC = 1_000_000.0


def _probe_job():
    sch = schema(TORCH)
    src = TORCH.SocketLineSource("S", sch, port=0, ts_field="timestamp")
    plan = TORCH.compile_plan(
        "from S[id == 2] select id, price insert into o", {"S": sch})
    job = TORCH.Job([plan], [src], batch_size=256, time_mode="processing")
    job.drain_interval_ms = 20.0
    job.tracer.sample_every = 1
    return job, src


def _nonce_of(row):
    p = float(row[1])
    return int(p - MAGIC) if p >= MAGIC / 2 else None


def _payloads(n, id_=2):
    return ['{"id": %d, "price": %.1f, "timestamp": %d}\n'
            % (id_, MAGIC + i, 1_000_000_000 + i * 8) for i in range(n)]


def _drive(job, prober, deadline_s=60.0):
    """Pump the run loop until the child's report lands (the deadline is
    a hang guard, not a measurement)."""
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        job.run_cycle()
        if prober.poll_result() is not None:
            return prober.result(5.0)
        time.sleep(0.001)
    return prober.result(5.0)


def test_prober_round_trips_through_real_socket_job():
    job, src = _probe_job()
    n = 25
    prober = SideChannelProber(src.host, src.port, _payloads(n),
                               period_s=0.03, timeout_s=15.0)
    job.add_sink("o", prober.make_sink(_nonce_of))
    with socket.create_connection((src.host, src.port)) as c:
        c.sendall(b'{"id": 2, "price": 1.0, "timestamp": 1000}\n')
    for _ in range(40):
        job.run_cycle()
    prober.start()
    report = _drive(job, prober)
    try:
        assert report is not None, "prober child produced no report"
        # a separate OS process, by its own pid
        assert isinstance(report.pid, int) and report.pid != os.getpid()
        assert prober.child_pid == report.pid
        assert report.n_sent == n
        assert report.n_received + len(report.lost) == n
        # the idle engine delivers every probe here; two may miss the
        # child's grace window on a loaded box
        assert report.n_received >= n - 2, (report.n_received, report.lost)
        assert report.clock == "child-monotonic"
        p99, p50 = report.percentile_ms(99), report.percentile_ms(50)
        assert p99 is not None and p99 > 0 and p50 <= p99
        trace = job.tracer.snapshot()
        # every event is sampled: each received probe completed a trace
        assert trace["e2e"]["count"] >= report.n_received
        assert trace["e2e"]["count"] == trace["completed"]
    finally:
        prober.close()
        src.close()
        job.run()


def test_prober_reports_losses_not_hangs():
    job, src = _probe_job()
    prober = SideChannelProber(src.host, src.port, _payloads(5, id_=7),
                               period_s=0.01, timeout_s=2.0)
    job.add_sink("o", prober.make_sink(_nonce_of))
    prober.start()
    report = _drive(job, prober, deadline_s=30.0)
    try:
        assert report is not None
        assert report.n_received == 0
        assert report.lost == [0, 1, 2, 3, 4]
        assert report.percentile_ms(99) is None
        # the engine saw the probes: stamped, never completed
        assert job.tracer.snapshot()["sampled"] == 5
        assert job.tracer.snapshot()["completed"] == 0
    finally:
        prober.close()
        src.close()
        job.run()


def test_probe_report_percentiles_nearest_rank():
    rep = ProbeReport(pid=1, n_sent=4,
                      rtt_ms={0: 10.0, 1: 20.0, 2: 30.0, 3: 40.0})
    assert rep.percentile_ms(50) == 20.0
    assert rep.percentile_ms(99) == 40.0
    assert rep.n_received == 4
    assert rep.to_dict()["n_received"] == 4


def test_the_child_imports_only_the_standard_library():
    """The child runs the module file as a script: it must not import the
    package, torch or numpy (it starts in milliseconds, with no engine
    state)."""
    import ast
    import flink_siddhi_tpu_torch.telemetry.prober as mod

    tree = ast.parse(open(mod.__file__).read())
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.add(node.module.split(".")[0])
    assert top <= {"__future__", "json", "os", "socket", "subprocess",
                   "sys", "threading", "time", "dataclasses", "typing"}
