"""Threaded JSON-over-HTTP front end of the serving plane (counterpart
of lightgbm_tpu/serve/server.py; stdlib ``http.server`` only).

Wraps a bare ``PredictorSession``, a ``ReplicaRouter`` or a whole
``ModelRegistry`` fleet.  The JAX package's protocol:

    POST /predict   body {"rows": [[...], ...], "raw_score": false,
                          "deadline_ms": 250, "model": "name",
                          "priority": "high|normal|low"}
                 -> 200 {"predictions": [...], "rows": N,
                         "latency_ms": ..., "trace_id": ...,
                         "model": ..., "version": V, "replica": "rI"}
                    (model/version/replica on a registry fleet: every
                    answer is attributable to one model version;
                    ``priority`` or the ``X-Priority`` header picks the
                    shedding class)
    POST /explain   body {"rows": [[...], ...], "deadline_ms": 250}
                 -> 200 {"contributions": [[...]], "rows": N,
                         "num_features": F, "num_class": K, ...}
                    (SHAP contributions, [F+1] a class, the last column
                    the expected value; 404 when ``tpu_explain=false``)
    POST /models/{name}/swap      body {"model_file": path}
                 -> 200 swap report; 409 when the canary gate rejected
    POST /models/{name}/rollback  body {"reason": "..."}
                 -> 200 rollback report; 409 when none is resident
    GET  /models       -> 200 registry listing (and the arena's tenants)
    GET  /health       -> 200 {"status": "ok"|"degraded", ...stats...}
    GET  /metrics      -> 200 Prometheus text
    GET  /stats        -> 200 the same numbers as JSON
    GET  /drift        -> 200 each model's drift monitor status and quality
                          breach ({"drift": null} where none is armed)
    GET  /debug/flight -> 200 the flight recorder's ring (``obs/spans.py``)

An incoming ``X-Request-Id`` header is honoured (sanitized) and echoed
back; otherwise one is minted here.  Replies that served a prediction
carry it in the body too; it is the trace id of the request's spans
(``serve/request``, the root, and the session's queue, coalesce, pad and
device spans under it), and each reply is a ``serve_access`` event.

Error mapping (JSON bodies with an ``error`` field):

- 400 malformed body or wrong feature count
- 503 queue full (``ServeOverloadError``: shed or retry elsewhere) or the
  device could not answer (``DeviceFailed``), both with ``Retry-After``
- 504 deadline exceeded in queue, or the reply wait timed out
- 500 anything else

No request is ever answered from the host: when a session's device path
fails, its requests fail with 503, ``/health`` reports the replica
degraded (``"status": "degraded"`` once no replica has a device path),
and the session re-probes the device every ``tpu_serve_reprobe_s``.
"""
from __future__ import annotations

import json
import re
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import obs
from ..utils import log
from .batcher import (DeadlineExceeded, DeviceFailed, ServeOverloadError,
                      normalize_priority)
from .metrics import render_prometheus, render_prometheus_fleet

# grace added to a request's own deadline before the HTTP thread gives
# up waiting on the batcher (the batch may be mid-flight on the device)
_REPLY_GRACE_S = 30.0
_DEFAULT_REPLY_TIMEOUT_S = 120.0

_MODEL_PATH = re.compile(r"^/models/([A-Za-z0-9._-]{1,64})/(swap|rollback)$")


def _json_safe(o):
    try:
        return o.item()  # numpy and torch scalars
    except Exception:  # noqa: BLE001
        return repr(o)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # stderr stays silent: the access log is the serve_access event
    def log_message(self, fmt, *args):  # noqa: A002
        pass

    def log_request(self, code="-", size="-"):
        """One ``serve_access`` event a reply: method, path, status,
        latency and trace id (no-op without telemetry or the ring)."""
        try:
            status = int(getattr(code, "value", code))
        except (TypeError, ValueError):
            status = 0
        t0 = getattr(self, "_t0", None)
        path = str(getattr(self, "path", "") or "?").split("?")[0]
        obs.event("serve_access",
                  method=str(getattr(self, "command", "") or "?"),
                  path=path.rstrip("/") or path[:1] or "?",
                  status=status,
                  latency_ms=(round((time.perf_counter() - t0) * 1e3, 3)
                              if t0 is not None else 0.0),
                  trace_id=getattr(self, "_trace_id", None) or "-")

    def _begin(self) -> None:
        """Per-request edge state: the start times and the trace id (an
        incoming ``X-Request-Id``, sanitized, else minted here)."""
        self._t0 = time.perf_counter()
        self._t0_wall = time.time()
        self._trace_id = obs.new_trace_id(self.headers.get("X-Request-Id"))
        self._status = None

    def _end(self) -> None:
        """Clear the per-request edge state: on a keep-alive connection
        the handler instance serves the next request too."""
        self._t0 = None
        self._trace_id = None

    def _reply(self, code: int, payload: dict, headers=None) -> None:
        body = json.dumps(payload, default=_json_safe).encode()
        self._reply_bytes(code, body, "application/json", headers=headers)

    def _reply_bytes(self, code: int, body: bytes, ctype: str,
                     headers=None) -> None:
        self._status = code
        try:
            self.server.session.metrics.count_status(code)
        except Exception:  # noqa: BLE001 — an empty registry must not 500
            pass
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if getattr(self, "_trace_id", None):
            self.send_header("X-Request-Id", self._trace_id)
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _shed_headers(self) -> dict:
        """503 responses tell the client when to come back
        (``tpu_serve_retry_after_s``)."""
        return {"Retry-After":
                "%g" % getattr(self.server, "retry_after_s", 1.0)}

    def do_GET(self):  # noqa: N802 — http.server API
        self._begin()
        try:
            reg = getattr(self.server, "registry", None)
            sess = self.server.session
            path = self.path.split("?")[0].rstrip("/")
            if path in ("", "/health"):
                st = sess.stats()
                # fleet view: a router serves through its replicas, so
                # "degraded" at the top level means NO replica still has
                # a healthy device path (all-degraded), not any-replica
                st["status"] = "degraded" if st.get("degraded") else "ok"
                if reg is not None:
                    st["models"] = {m["name"]: m for m in reg.models()}
                    arena = getattr(reg, "arena", None)
                    if arena is not None:
                        st["arena"] = arena.stats()
                self._reply(200, st)
            elif path == "/metrics":
                text = (render_prometheus_fleet(reg) if reg is not None
                        else render_prometheus(sess))
                self._reply_bytes(200, text.encode(),
                                  "text/plain; version=0.0.4")
            elif path == "/stats":
                body = {"stats": sess.stats(),
                        "metrics": sess.metrics.snapshot()}
                if reg is not None:
                    body["models"] = reg.stats()
                    arena = getattr(reg, "arena", None)
                    if arena is not None:
                        body["arena"] = {"stats": arena.stats(),
                                         "tenants": arena.tenants()}
                self._reply(200, body)
            elif path == "/models":
                if reg is None:
                    self._reply(404, {"error": "no_registry",
                                      "detail": "server wraps a bare "
                                      "session, not a model registry"})
                else:
                    body = {"default": reg.default,
                            "models": reg.models()}
                    arena = getattr(reg, "arena", None)
                    if arena is not None:
                        # residency view: which tenants are device-
                        # resident, eviction/occupancy counters
                        body["arena"] = {"stats": arena.stats(),
                                         "tenants": arena.tenants()}
                    self._reply(200, body)
            elif path == "/drift":
                # each model's monitor status and quality-breach latch
                if reg is not None:
                    self._reply(200, {"models": {
                        m["name"]: {"drift": m.get("drift"),
                                    "quality_breach": m.get(
                                        "quality_breach")}
                        for m in reg.models()}})
                else:
                    dr = sess.stats().get("drift")
                    self._reply(200, {"drift": dr, "armed": bool(dr)})
            elif path == "/debug/flight":
                self._reply(200, {"enabled": obs.flight_enabled(),
                                  "ring_len": obs.flight_len(),
                                  "events": obs.flight_snapshot()})
            else:
                self._reply(404, {"error": "not_found", "path": self.path})
        finally:
            self._end()

    def do_POST(self):  # noqa: N802 — http.server API
        self._begin()
        path = self.path.split("?")[0].rstrip("/")
        m = _MODEL_PATH.match(path)
        if m is not None:
            try:
                self._do_admin(m.group(1), m.group(2))
            finally:
                self._end()
            return
        if path not in ("/predict", "/explain"):
            try:
                self._reply(404, {"error": "not_found", "path": self.path})
            finally:
                self._end()
            return
        explain = path == "/explain"
        reg = getattr(self.server, "registry", None)
        t0 = self._t0
        root_id = obs.new_span_id() if obs.span_record_enabled() else None
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
            payload = json.loads(self.rfile.read(length) or b"{}")
            # fleet routing: the body's "model" picks a registered model
            # (default model when absent); a bare-session server ignores
            # it.  Resolution happens HERE, once — the resolved version
            # serves this whole request even if a swap lands mid-flight
            model = payload.get("model")
            version = None
            arena_hit = False
            if reg is not None:
                from .registry import UnknownModelError
                arena = getattr(reg, "arena", None)
                try:
                    ver = reg.resolve(model)
                except UnknownModelError:
                    # arena tenants serve names the version registry
                    # does not know (registered names always win)
                    if arena is not None and (
                            model is None or arena.has(model)):
                        sess, arena_hit = arena, True
                    else:
                        self._reply(404, {"error": "unknown_model",
                                          "model": model})
                        return
                else:
                    sess, model, version = ver.router, ver.router.name, \
                        ver.version
            else:
                sess = self.server.session
            if explain and arena_hit:
                self._reply(404, {"error": "explain_disabled",
                                  "detail": "arena tenants serve "
                                  "predictions only"})
                return
            if explain and not getattr(sess, "explain_enabled", False):
                self._reply(404, {"error": "explain_disabled",
                                  "detail": "explanation serving is off "
                                  "(tpu_explain=false)"})
                return
            rows = payload.get("rows")
            if rows is None:
                raise ValueError("body needs a 'rows' matrix")
            X = np.asarray(rows, dtype=np.float64)
            deadline_ms = payload.get("deadline_ms")
            # priority class for load shedding: body field wins, then
            # the X-Priority header; anything unknown serves as normal
            priority = normalize_priority(
                payload.get("priority")
                or self.headers.get("X-Priority"))
            if explain:
                ticket = sess.submit_explain(X, deadline_ms=deadline_ms,
                                             trace_id=self._trace_id,
                                             parent_id=root_id,
                                             priority=priority)
            elif arena_hit:
                ticket = sess.submit(
                    X, model=model, deadline_ms=deadline_ms,
                    raw_score=bool(payload.get("raw_score")),
                    trace_id=self._trace_id, parent_id=root_id,
                    priority=priority)
            else:
                ticket = sess.submit(
                    X, deadline_ms=deadline_ms,
                    raw_score=bool(payload.get("raw_score")),
                    trace_id=self._trace_id, parent_id=root_id,
                    priority=priority)
            wait_s = (float(deadline_ms) / 1e3 + _REPLY_GRACE_S
                      if deadline_ms is not None
                      else _DEFAULT_REPLY_TIMEOUT_S)
            pred = sess.result(ticket, timeout=wait_s)
            body = {
                "rows": int(ticket.rows),
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 3),
                "trace_id": self._trace_id,
            }
            if version is not None:
                # every response is attributable to exactly one model
                # version (the ticket's, which survived any mid-flight
                # swap)
                body["model"] = model
                body["version"] = int(getattr(ticket, "version", version))
                if getattr(ticket, "replica", None) is not None:
                    body["replica"] = f"r{ticket.replica.idx}"
            elif arena_hit:
                body["model"] = ticket.model
                body["arena"] = True
            if explain:
                # [n, F+1] (or [n, K*(F+1)] multiclass); the last column
                # per class block is the expected value, like
                # predict_contrib
                body["contributions"] = np.asarray(pred).tolist()
                body["num_features"] = int(sess.num_features)
                body["num_class"] = int(sess.num_tpi)
            else:
                body["predictions"] = np.asarray(pred).tolist()
            self._reply(200, body)
        except ServeOverloadError as exc:
            self._reply(503, {"error": "overloaded", "detail": str(exc),
                              "priority": getattr(exc, "priority",
                                                  "normal"),
                              "shed": bool(getattr(exc, "shed", False))},
                        headers=self._shed_headers())
        except DeviceFailed as exc:
            self._reply(503, {"error": "device_failed", "detail": str(exc)},
                        headers=self._shed_headers())
        except (DeadlineExceeded, _FutureTimeout) as exc:
            self._reply(504, {"error": "deadline_exceeded",
                              "detail": str(exc)})
        except (ValueError, TypeError, KeyError) as exc:
            self._reply(400, {"error": "bad_request", "detail": str(exc)})
        except Exception as exc:  # noqa: BLE001 — HTTP thread must reply
            self._reply(500, {"error": type(exc).__name__,
                              "detail": str(exc)})
        finally:
            if root_id is not None:
                # the request's root span, parent of the session's spans
                obs.emit_span(
                    "explain/request" if explain else "serve/request",
                    self._t0_wall, (time.perf_counter() - t0) * 1e3,
                    self._trace_id, span_id=root_id,
                    attrs={"status": self._status, "path": path})
            self._end()

    def _do_admin(self, name: str, action: str) -> None:
        """POST /models/{name}/swap  body {"model_file": path}
        POST /models/{name}/rollback  body {"reason": "..."} —
        the registry's governed transitions over HTTP.  A canary-gate
        rejection maps to 409 (the flip did not happen; the previous
        version keeps serving)."""
        reg = getattr(self.server, "registry", None)
        if reg is None:
            self._reply(404, {"error": "no_registry",
                              "detail": "server wraps a bare session, "
                              "not a model registry"})
            return
        from .registry import SwapRejected, UnknownModelError
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
            payload = json.loads(self.rfile.read(length) or b"{}")
            if action == "swap":
                model = (payload.get("model_file")
                         or payload.get("model"))
                if not model:
                    raise ValueError("swap body needs 'model_file'")
                arena = getattr(reg, "arena", None)
                registered = name in [m["name"] for m in reg.models()]
                if (arena is not None and not registered
                        and (arena.has(name) or payload.get("arena"))):
                    # arena tenant hot-swap (or first admit with
                    # {"arena": true}) — canary-gated inside the arena;
                    # a parity failure rolls back and maps to 409 below
                    try:
                        report = arena.swap(name, model)
                    except (RuntimeError, ValueError) as exc:
                        self._reply(409, {"error": "swap_rejected",
                                          "detail": str(exc),
                                          "arena": True})
                        return
                    self._reply(200, report)
                    return
                report = (reg.swap(name, model) if registered
                          else reg.add_model(name, model))
                self._reply(200, report)
            else:  # rollback
                report = reg.rollback(
                    name, reason=str(payload.get("reason") or "manual"))
                self._reply(200, report)
        except SwapRejected as exc:
            self._reply(409, {"error": "swap_rejected",
                              "detail": str(exc),
                              "report": exc.report})
        except UnknownModelError:
            self._reply(404, {"error": "unknown_model", "model": name})
        except (ValueError, TypeError, KeyError) as exc:
            self._reply(400, {"error": "bad_request", "detail": str(exc)})
        except RuntimeError as exc:
            # rollback without a resident previous version
            self._reply(409, {"error": "conflict", "detail": str(exc)})
        except Exception as exc:  # noqa: BLE001 — HTTP thread must reply
            self._reply(500, {"error": type(exc).__name__,
                              "detail": str(exc)})


class _FleetHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose ``session`` resolves through the model
    registry at ACCESS time (so /health, /metrics and the status
    counters always describe the CURRENT live version after a swap),
    falling back to the bare session the server was built with."""

    registry = None
    bare_session = None
    retry_after_s = 1.0

    @property
    def session(self):
        if self.registry is not None:
            return self.registry.resolve(None).router
        return self.bare_session


class PredictServer:
    """Threaded HTTP server wrapping one serving target; ``port=0``
    binds an ephemeral port (read it back from ``.port``).

    The target may be a bare ``PredictorSession`` (the original
    single-model surface), a ``ReplicaRouter``, or a ``ModelRegistry``
    — a registry additionally arms the fleet endpoints (``GET /models``,
    ``POST /models/{name}/swap`` and ``/models/{name}/rollback``,
    per-model ``/health`` blocks, ``model``/``version`` echo on every
    prediction)."""

    def __init__(self, target, host: str = "127.0.0.1", port: int = 0):
        is_registry = (hasattr(target, "resolve")
                       and hasattr(target, "swap"))
        self.registry = target if is_registry else None
        self._httpd = _FleetHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        if is_registry:
            self._httpd.registry = target
            cfg = getattr(target, "config", None)
            self._httpd.retry_after_s = float(
                getattr(cfg, "tpu_serve_retry_after_s", 1.0) or 1.0)
        else:
            self._httpd.bare_session = target
            cfg = getattr(target, "config", None)
            if not isinstance(cfg, dict):
                self._httpd.retry_after_s = float(
                    getattr(cfg, "tpu_serve_retry_after_s", 1.0) or 1.0)
        self._thread = None

    @property
    def session(self):
        """The current serving target (post-swap: the NEW live router)."""
        return self._httpd.session

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "PredictServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="lgbm-serve-http",
            daemon=True)
        self._thread.start()
        log.info("serving %d trees on %s (POST /predict%s, GET /health "
                 "/metrics /stats /models)",
                 self.session.num_trees, self.url,
                 " /explain" if getattr(self.session, "explain_enabled",
                                        False) else "")
        return self

    def stop(self, close_session: bool = False) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        if close_session:
            # a registry owns (and closes) every resident version; a
            # bare session/router closes itself
            (self.registry if self.registry is not None
             else self.session).close()

    def serve_forever(self) -> None:
        """Blocking CLI entry: run until interrupted, then drain the
        session's queue before exiting (graceful shutdown)."""
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            log.info("serve: interrupt — draining and shutting down")
        finally:
            self.stop(close_session=True)

    def __enter__(self) -> "PredictServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(close_session=True)
