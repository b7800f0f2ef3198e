"""Out-of-process side-channel RTT prober.

The falsifiability device the round-5 verdict asked for: every latency
number the engine reports about itself is stamped by clocks the engine
owns. This prober is the independent witness — a **separate OS
process** (``subprocess`` running this file as a standalone script; it
never imports the package, jax, or numpy) that

1. injects timestamped sentinel events into the engine through the
   REAL ingest path (a TCP connection to a ``SocketLineSource`` — the
   same bytes a production client would send),
2. receives an ack for each sentinel's *match* the moment the row
   surfaces to a sink (the host forwards the sentinel's sequence
   number over a plain TCP ack channel), and
3. computes per-probe round-trip times entirely from its **own
   monotonic clock** — send stamped in the child, receive stamped in
   the child.

The resulting p50/p99 is an end-to-end ingest→match-visibility
measurement the system under test cannot game: it includes socket
transit, decode, reorder queueing, device dispatch + backlog, drain,
host decode, sink delivery, and the ack hop back. bench.py reports it
NEXT TO the in-process telemetry numbers and prints the discrepancy
ratio; a large ratio means the internal accounting is lying (or the
ack/ingest hops dominate — the docs say how to tell).

Wire protocol (parent <-> child):

* parent -> child stdin: one JSON config
  ``{"ingest_host", "ingest_port", "payloads": [str, ...],
  "period_s", "timeout_s"}`` — ``payloads[i]`` is the exact byte
  string (newline-terminated line(s)) to send for probe ``i``;
* child -> parent stdout line 1:
  ``{"hello": true, "pid": P, "ack_port": N}``;
* parent -> child ack socket: ``b"<seq>\\n"`` per observed match;
* child -> parent stdout line 2 (final report):
  ``{"pid", "n_sent", "rtt_ms": {seq: ms}, "lost": [seq, ...],
  "clock": "child-monotonic"}``.

This module is importable from the package (the parent-side
``SideChannelProber``) AND runnable as ``python prober.py`` (the child
entry point). Only stdlib imports at module scope — the child must
start in milliseconds and must not inherit any engine state.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


def _nearest_rank(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    k = max(int(-(-q / 100.0 * len(sorted_vals) // 1)), 1)  # ceil
    return sorted_vals[min(k, len(sorted_vals)) - 1]


@dataclass
class ProbeReport:
    """Parsed child report: RTTs measured on the child's clock."""

    pid: int
    n_sent: int
    rtt_ms: Dict[int, float]
    lost: List[int] = field(default_factory=list)
    clock: str = "child-monotonic"

    @property
    def n_received(self) -> int:
        return len(self.rtt_ms)

    @property
    def samples_ms(self) -> List[float]:
        return sorted(self.rtt_ms.values())

    def percentile_ms(self, q: float) -> Optional[float]:
        v = _nearest_rank(self.samples_ms, q)
        return None if v is None else round(v, 3)

    def to_dict(self) -> Dict[str, object]:
        return {
            "pid": self.pid,
            "n_sent": self.n_sent,
            "n_received": self.n_received,
            "lost": len(self.lost),
            "p50_ms": self.percentile_ms(50),
            "p99_ms": self.percentile_ms(99),
            "clock": self.clock,
        }


class SideChannelProber:
    """Parent-side handle: spawn the child, forward match acks, collect
    the report.

    Usage::

        prober = SideChannelProber(src.host, src.port, payloads,
                                   period_s=0.05)
        job.add_sink("matches", prober.make_sink(nonce_of))
        prober.start()
        while prober.poll_result() is None:
            job.run_cycle()
        report = prober.result()
    """

    def __init__(
        self,
        ingest_host: str,
        ingest_port: int,
        payloads: Sequence[str],
        period_s: float = 0.05,
        timeout_s: float = 20.0,
    ) -> None:
        self.config = {
            "ingest_host": ingest_host,
            "ingest_port": int(ingest_port),
            "payloads": [str(p) for p in payloads],
            "period_s": float(period_s),
            "timeout_s": float(timeout_s),
        }
        self._proc: Optional[subprocess.Popen] = None
        self._ack_sock: Optional[socket.socket] = None
        self._ack_lock = threading.Lock()
        self._ack_backlog: List[int] = []
        self._hello: Optional[dict] = None
        self._report: Optional[ProbeReport] = None
        self._done = threading.Event()
        self._acked: set = set()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "SideChannelProber":
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            # stderr inherited: child tracebacks surface to the operator
            text=True,
        )
        self._proc.stdin.write(json.dumps(self.config))
        self._proc.stdin.close()
        threading.Thread(target=self._read_stdout, daemon=True).start()
        return self

    # fst:thread-root name=prober
    def _read_stdout(self) -> None:
        try:
            for line in self._proc.stdout:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                msg = json.loads(line)
                if msg.get("hello"):
                    self._hello = msg
                    self._connect_ack(msg["ack_port"])
                elif "rtt_ms" in msg:
                    self._report = ProbeReport(
                        pid=int(msg["pid"]),
                        n_sent=int(msg["n_sent"]),
                        rtt_ms={
                            int(k): float(v)
                            for k, v in msg["rtt_ms"].items()
                        },
                        lost=[int(x) for x in msg.get("lost", [])],
                        clock=msg.get("clock", "child-monotonic"),
                    )
        finally:
            self._done.set()

    def _connect_ack(self, port: int) -> None:
        sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        with self._ack_lock:
            self._ack_sock = sock
            backlog, self._ack_backlog = self._ack_backlog, []
        for seq in backlog:  # already in _acked: send directly
            self._send_ack(sock, seq)

    @staticmethod
    def _send_ack(sock: socket.socket, seq: int) -> None:
        try:
            sock.sendall(b"%d\n" % seq)
        except OSError:
            pass  # child gone: report (or its absence) tells the story

    @property
    def child_pid(self) -> Optional[int]:
        """PID from the child's OWN hello (os.getpid() in the child) —
        what tests assert against the parent's pid."""
        return None if self._hello is None else int(self._hello["pid"])

    # -- ack path ----------------------------------------------------------
    def ack(self, seq: int) -> None:
        """Forward one observed sentinel match to the child. Called from
        the job's sink (run-loop thread); idempotent per seq."""
        seq = int(seq)
        if seq in self._acked:
            return
        self._acked.add(seq)
        with self._ack_lock:
            sock = self._ack_sock
            if sock is None:
                self._ack_backlog.append(seq)
                return
        self._send_ack(sock, seq)

    def make_sink(
        self, nonce_of: Callable[[tuple], Optional[int]]
    ) -> Callable[[int, tuple], None]:
        """A Job sink callback that acks rows ``nonce_of`` recognizes
        (returns the probe seq, or None for ordinary traffic)."""

        def sink(_abs_ts: int, row: tuple) -> None:
            seq = nonce_of(row)
            if seq is not None:
                self.ack(seq)

        return sink

    # -- results -----------------------------------------------------------
    def poll_result(self) -> Optional[ProbeReport]:
        return self._report

    def result(self, timeout: Optional[float] = None) -> Optional[ProbeReport]:
        """Wait for the child's final report (None on timeout/crash)."""
        self._done.wait(timeout)
        return self._report

    def close(self) -> None:
        with self._ack_lock:
            if self._ack_sock is not None:
                try:
                    self._ack_sock.close()
                except OSError:
                    pass
                self._ack_sock = None
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait(timeout=5)


# ---------------------------------------------------------------------------
# child entry point (separate OS process; stdlib only, no package import)
# ---------------------------------------------------------------------------


def _child_main() -> int:
    cfg = json.load(sys.stdin)
    payloads: List[bytes] = [p.encode() for p in cfg["payloads"]]
    period = float(cfg["period_s"])
    timeout = float(cfg["timeout_s"])

    # ack channel first, so the hello line carries a live port
    ack_srv = socket.create_server(("127.0.0.1", 0))
    ack_port = ack_srv.getsockname()[1]

    t_recv: Dict[int, float] = {}
    recv_lock = threading.Lock()

    # fst:thread-root name=prober-ack
    def ack_loop() -> None:
        try:
            conn, _ = ack_srv.accept()
        except OSError:
            return
        buf = b""
        while True:
            try:
                chunk = conn.recv(4096)
            except OSError:
                return
            if not chunk:
                return
            now = time.monotonic()  # stamp ONCE per recv, our clock
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                try:
                    seq = int(line)
                except ValueError:
                    continue
                with recv_lock:
                    t_recv.setdefault(seq, now)

    threading.Thread(target=ack_loop, daemon=True).start()
    print(
        json.dumps(
            {"hello": True, "pid": os.getpid(), "ack_port": ack_port}
        ),
        flush=True,
    )

    # ingest connection (the engine's socket source): a few retries in
    # case the parent raced us to stdout
    last_err: Optional[Exception] = None
    sock = None
    for _ in range(50):
        try:
            sock = socket.create_connection(
                (cfg["ingest_host"], cfg["ingest_port"]), timeout=5
            )
            break
        except OSError as e:
            last_err = e
            time.sleep(0.1)
    if sock is None:
        raise SystemExit(f"prober: ingest connect failed: {last_err}")
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    t_sent: Dict[int, float] = {}
    t0 = time.monotonic()
    for i, payload in enumerate(payloads):
        due = t0 + i * period
        while True:
            now = time.monotonic()
            if now >= due:
                break
            time.sleep(min(due - now, 0.01))
        t_sent[i] = time.monotonic()
        sock.sendall(payload)

    # grace period for stragglers, ended early once everything acked
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with recv_lock:
            if len(t_recv) >= len(payloads):
                break
        time.sleep(0.02)

    with recv_lock:
        rtt_ms = {
            seq: round((t_recv[seq] - t_sent[seq]) * 1e3, 3)
            for seq in t_recv
            if seq in t_sent
        }
    lost = sorted(set(t_sent) - set(rtt_ms))
    print(
        json.dumps(
            {
                "pid": os.getpid(),
                "n_sent": len(t_sent),
                "rtt_ms": rtt_ms,
                "lost": lost,
                "clock": "child-monotonic",
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(_child_main())
