"""REST query-management service.

The port of ``flink_siddhi_tpu/app/service.py``. The reference sketched
this API and left every route unimplemented (CEPService.scala:43-95:
``/api/v1/queries`` CRUD, all bodies ``???``). This is the working
version: a small stdlib HTTP server that translates REST calls into
control events (``control/events.py``) pushed onto a
``ControlQueueSource`` that a running ``Job`` consumes at epoch
boundaries — the path a control stream takes. A handler thread only runs
the caller's ``validate`` and pushes events: it never touches the job's
state, launches on the card or captures a graph (the run loop does all
of that when it applies the event).

Routes (JSON in/out, unless stated):
    GET    /api/v1/metrics               -> Job.metrics() snapshot
    GET    /api/v1/metrics/prometheus    -> Job.openmetrics(): Prometheus
                                           text format 0.0.4
                                           (telemetry/openmetrics.py)
    GET    /api/v1/traces                -> the trace sampler's snapshot
                                           (telemetry/tracing.py)
    GET    /api/v1/flightrecorder        -> {"seq", "events"}: the
                                           journal (telemetry/flightrec.py),
                                           filtered by ?kind= (dotted
                                           prefix), ?plan=, ?tenant=,
                                           ?since_seq= (strictly after),
                                           ?limit= (default 512)
    GET    /api/v1/slo                   -> the SLO watchdog's snapshot
                                           (telemetry/slo.py)
    GET    /api/v1/health                -> liveness: alive, processed
                                           events, idle sources, the late
                                           account, the control block
                                           (job.control_status()) and the
                                           SLO watchdog's compact block;
                                           with a supervisor its health()
                                           (503 once its restart budget
                                           is spent)
    GET    /api/v1/queries               -> {"queries": [{id, tenant,
                                           enabled, folded}]}
    GET    /api/v1/queries/<id>          -> per-query status: enabled,
                                           tenant, fold host/slot and its
                                           scoped metrics
                                           (Job.plan_metrics), or the
                                           recorded refusal (rule ids)
    POST   /api/v1/queries   {"cql": s,
                              "tenant"?,
                              "id"?}     -> {"id": plan_id,
                                            "admission": summary}
    PUT    /api/v1/queries/<id> {"cql"}  -> {"id": id,
                                            "admission": summary}
    DELETE /api/v1/queries/<id>          -> {"id": id}
    POST   /api/v1/queries/<id>/enable   -> {"id": id}
    POST   /api/v1/queries/<id>/disable  -> {"id": id}

Admission: construct the service with
``admission=control.plane.AdmissionGate(compile_fn, budgets)`` and every
POST/PUT body is compiled, plan-verified and admission-analyzed BEFORE an
event is pushed — on the handler thread, on meta tensors and the CPU, so
it never touches the card while the run loop captures a graph. A hostile
or over-budget query is refused at the boundary with HTTP 422 and the
exact PLC/ADM rule ids in the body (and recorded in the job's rejection
ring); a passing verdict rides the control event, and the executor
re-checks it at apply time.

Every read route takes host-side snapshots under the telemetry modules'
locks (the flight recorder's ``seq`` read before its events, so a cursor
client can only re-read an entry, never skip one): none waits for the
card or mutates run-loop state.

Not in the port yet, answering 501 with a body naming its ROADMAP.md
Queue 1 item: the fleet's ``POST /api/v1/fleet/drain`` (item 13).
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import numpy as np

from ..control.events import MetadataControlEvent, OperationControlEvent

# POST routes whose modules wait for a later ROADMAP item
_LATER_ROUTES = {
    ("api", "v1", "fleet", "drain"): (
        13, "the serving fleet's drain (fleet/)"),
}


def _later_body(item: int, what: str) -> dict:
    return {"error": f"{what} is not in the torch port yet (ROADMAP.md "
                     f"Queue 1 item {item})"}


def _json_safe(obj):
    """A metrics snapshot as JSON-serializable primitives: numpy scalars
    and arrays become Python ints, floats and lists."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [_json_safe(v) for v in obj.tolist()]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)


class ControlQueueSource:
    """Push-style control source: the service enqueues events, the job's
    executor drains them at epoch boundaries. Stays open until
    ``close()`` (a pipeline with a live control service never finishes on
    its own). ``push``, ``close`` and ``poll`` are thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: List[Tuple[int, object]] = []
        self._closed = False

    def push(self, event, timestamp_ms: Optional[int] = None) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("control source closed")
            ts = (
                int(timestamp_ms)
                if timestamp_ms is not None
                else int(event.created_ms)
            )
            self._pending.append((ts, event))

    def close(self) -> None:
        with self._lock:
            self._closed = True

    def poll(self, max_events: int):
        with self._lock:
            take = self._pending[:max_events]
            self._pending = self._pending[max_events:]
            done = self._closed and not self._pending
            # a live (empty) control queue must not hold back the data
            # watermark: control applies at the next batch boundary anyway
            wm = np.iinfo(np.int64).max if (done or not self._pending) else (
                take[-1][0] if take else None
            )
            return take, wm, done


class QueryControlService:
    """HTTP facade over a ControlQueueSource (optionally reading a live
    Job for the GET routes)."""

    def __init__(
        self,
        control: ControlQueueSource,
        job=None,
        host: str = "127.0.0.1",
        port: int = 0,
        validate=None,  # callable(cql) raising on bad queries
        supervisor=None,  # runtime.supervisor.Supervisor for /health
        admission=None,  # AdmissionGate: (cql, plan_id) -> summary
    ) -> None:
        self.control = control
        self.admission = admission
        self.job = job
        self.validate = validate
        self.supervisor = supervisor
        service = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _reply(self, code: int, payload: dict) -> None:
                self._reply_text(code, json.dumps(payload),
                                 "application/json")

            def _reply_text(self, code: int, text: str,
                            content_type: str) -> None:
                body = text.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length") or 0)
                if not n:
                    return {}
                try:
                    return json.loads(self.rfile.read(n))
                except ValueError:
                    return {}

            def _route(self):
                parts = [p for p in self.path.split("/") if p]
                # expect ['api', 'v1', 'queries', <id>?, <action>?]
                if parts[:3] != ["api", "v1", "queries"]:
                    return None
                return parts[3:]

            def do_GET(self):
                from urllib.parse import parse_qs, urlsplit

                url = urlsplit(self.path)
                parts = tuple(p for p in url.path.split("/") if p)
                if parts == ("api", "v1", "flightrecorder"):
                    return self._reply(*service._flightrecorder(
                        parse_qs(url.query)))
                if parts == ("api", "v1", "health"):
                    return self._reply(*service._health())
                if parts == ("api", "v1", "slo"):
                    slo = getattr(service._live_job(), "slo", None)
                    return self._reply(
                        200, {} if slo is None
                        else _json_safe(slo.snapshot()))
                if parts == ("api", "v1", "metrics", "prometheus"):
                    from ..telemetry.openmetrics import CONTENT_TYPE

                    job = service._live_job()
                    return self._reply_text(
                        200, "# no job attached\n" if job is None
                        else job.openmetrics(), CONTENT_TYPE)
                if parts == ("api", "v1", "metrics"):
                    job = service._live_job()
                    if job is None:
                        return self._reply(200, {})
                    # host-side counters only: never touches the device
                    # from this thread
                    return self._reply(200, _json_safe(job.metrics()))
                if parts == ("api", "v1", "traces"):
                    tracer = getattr(service._live_job(), "tracer", None)
                    return self._reply(
                        200, {} if tracer is None
                        else _json_safe(tracer.snapshot()))
                tail = self._route()
                if tail is None:
                    return self._reply(404, {"error": "not found"})
                if len(tail) == 1:
                    return self._reply(*service._query_status(tail[0]))
                if tail:
                    return self._reply(404, {"error": "not found"})
                job = service._live_job()
                listing = job.query_listing() if job is not None else []
                self._reply(200, {"queries": _json_safe(listing)})

            def do_POST(self):
                parts = tuple(p for p in self.path.split("/") if p)
                later = _LATER_ROUTES.get(parts)
                if later is not None:
                    return self._reply(501, _later_body(*later))
                tail = self._route()
                if tail is None:
                    return self._reply(404, {"error": "not found"})
                if not tail:  # add query
                    body = self._body()
                    cql = body.get("cql")
                    if not cql:
                        return self._reply(400, {"error": "missing cql"})
                    err = service._check(cql)
                    if err:
                        return self._reply(400, {"error": err})
                    # a client may supply the plan id; otherwise the
                    # service mints one
                    plan_id = body.get("id")
                    if plan_id is not None and (
                        not isinstance(plan_id, str)
                        or not re.fullmatch(r"[\w.:-]{1,128}", plan_id)
                    ):
                        return self._reply(400, {"error": "invalid id"})
                    if plan_id is None:
                        plan_id = MetadataControlEvent.new_plan_id()
                    summary, reject = service._admit(
                        cql, plan_id, tenant=body.get("tenant"))
                    if reject is not None:
                        return self._reply(422, reject)
                    b = MetadataControlEvent.builder()
                    b.add_execution_plan(cql, admission=summary,
                                         plan_id=plan_id)
                    ev = b.build()
                    ev.tenant = body.get("tenant")
                    service.control.push(ev)
                    return self._reply(
                        201, {"id": plan_id, "admission": summary})
                if len(tail) == 2 and tail[1] in ("enable", "disable"):
                    ev = (
                        OperationControlEvent.enable_query(tail[0])
                        if tail[1] == "enable"
                        else OperationControlEvent.disable_query(tail[0])
                    )
                    service.control.push(ev)
                    return self._reply(200, {"id": tail[0]})
                self._reply(404, {"error": "not found"})

            def do_PUT(self):
                tail = self._route()
                if tail is None or len(tail) != 1:
                    return self._reply(404, {"error": "not found"})
                body = self._body()
                cql = body.get("cql")
                if not cql:
                    return self._reply(400, {"error": "missing cql"})
                err = service._check(cql)
                if err:
                    return self._reply(400, {"error": err})
                summary, reject = service._admit(
                    cql, tail[0], tenant=body.get("tenant"))
                if reject is not None:
                    return self._reply(422, reject)
                b = MetadataControlEvent.builder()
                b.update_execution_plan(tail[0], cql)
                if summary is not None:
                    b.with_admission(tail[0], summary)
                ev = b.build()
                ev.tenant = body.get("tenant")
                service.control.push(ev)
                self._reply(200, {"id": tail[0], "admission": summary})

            def do_DELETE(self):
                tail = self._route()
                if tail is None or len(tail) != 1:
                    return self._reply(404, {"error": "not found"})
                b = MetadataControlEvent.builder()
                b.remove_execution_plan(tail[0])
                service.control.push(b.build())
                self._reply(200, {"id": tail[0]})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    def _live_job(self):
        """The job every GET route reads: the attached one, else the
        supervised pipeline's current job (None mid-restart)."""
        job = self.job
        if job is None and self.supervisor is not None:
            job = self.supervisor.job
        return job

    def _admit(self, cql: str, plan_id: str, tenant=None):
        """Run the admission gate at the REST boundary. Returns
        ``(summary, None)`` on pass (summary None when no gate is
        configured) or ``(None, reject_payload)`` carrying the exact
        PLC/ADM rule ids — the 422 body. A refusal is also recorded in
        the attached job's rejection ring (source ``"service"``), so it
        shows in ``GET /health`` and ``GET /queries/<id>`` like an
        apply-time one."""
        if self.admission is None:
            return None, None
        from ..control.plane import ControlRejected

        try:
            return self.admission(cql, plan_id), None
        except ControlRejected as e:
            rules, findings = e.rules, e.findings
        except Exception as e:  # noqa: BLE001 — unparsable CQL etc.
            rules, findings = ["CQL000"], [f"{type(e).__name__}: {e}"]
        job = self._live_job()
        if job is not None:
            job._record_rejection(
                plan_id, rules, findings, tenant, source="service"
            )
        return None, {
            "error": "admission rejected",
            "id": plan_id,
            "rules": rules,
            "findings": findings,
        }

    def _health(self):
        """(code, payload) for GET /api/v1/health: 200 while supervised
        and alive (or unsupervised), 503 once the supervisor's restart
        budget is spent."""
        sup = self.supervisor
        if sup is not None:
            payload = _json_safe(sup.health())
            return (200 if payload.get("alive") else 503), payload
        job = self.job
        if job is None:
            return 200, {"alive": True, "supervised": False}
        slo = getattr(job, "slo", None)
        return 200, {
            "alive": True,
            "supervised": False,
            "finished": bool(job.finished),
            "processed_events": int(job.processed_events),
            "idle_sources": job.idle_source_ids(),
            "late_dropped": int(job.late_dropped),
            "control": _json_safe(job.control_status()),
            # the SLO watchdog's compact, alertable view
            "slo": _json_safe(slo.health_summary()
                              if slo is not None else None),
        }

    def _flightrecorder(self, query: dict):
        """(code, payload) for GET /api/v1/flightrecorder: the journal
        filtered by kind / plan / tenant / since_seq / limit."""
        fr = getattr(self._live_job(), "flightrec", None)
        if fr is None:
            return 200, {"seq": 0, "events": []}

        def one(name):
            v = query.get(name)
            return v[0] if v else None

        # seq BEFORE events(): an entry recorded between the two reads
        # (separate lock acquisitions) is then re-read by a cursor
        # client's next poll, never skipped
        seq = fr.seq
        try:
            since, limit = one("since_seq"), one("limit")
            events = fr.events(
                kind=one("kind"), plan=one("plan"), tenant=one("tenant"),
                since_seq=int(since) if since is not None else None,
                limit=int(limit) if limit is not None else 512,
            )
        except ValueError:
            return 400, {"error": "since_seq/limit must be ints"}
        return 200, {"seq": seq, "events": _json_safe(events)}

    def _query_status(self, plan_id: str):
        """(code, payload) for GET /api/v1/queries/<id>."""
        job = self._live_job()
        if job is None:
            return 404, {"error": "no job attached"}
        folded = job._folded.get(plan_id)
        if folded is not None:
            host, slot = folded
            return 200, {
                "id": plan_id,
                "state": "live",
                "tenant": job.tenant_of(plan_id),
                "enabled": bool(job._folded_enabled.get(plan_id, True)),
                "folded": {"host": host, "slot": int(slot)},
                # live scoped metrics: rows, matches, drain legs and the
                # host's footprint
                "metrics": _json_safe(job.plan_metrics(plan_id)),
            }
        rt = job._plans.get(plan_id)
        if rt is not None:
            return 200, {
                "id": plan_id,
                "state": "live",
                "tenant": job.tenant_of(plan_id),
                "enabled": bool(rt.enabled),
                "folded": None,
                "metrics": _json_safe(job.plan_metrics(plan_id)),
            }
        rej = job.control_rejections.get(plan_id)
        if rej is not None:
            return 200, {"id": plan_id, "state": "rejected",
                         **_json_safe(rej)}
        return 404, {"error": f"unknown query {plan_id!r}"}

    def _check(self, cql: str) -> Optional[str]:
        """Fail-fast validation at the REST boundary (the reference's
        validateSiddhiApp, AbstractSiddhiOperator.java:291-299): an error
        string, or None."""
        if self.validate is None:
            return None
        try:
            self.validate(cql)
            return None
        except Exception as e:
            return str(e)

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "QueryControlService":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
