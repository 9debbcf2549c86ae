"""``task=online``: the closed loop from served traffic to fresh models
(counterpart of lightgbm_tpu/online/loop.py).

The serving fleet (``serve/``) answers predictions, and the labels of
those predictions arrive later as a stream.  This loop reads that
stream (JSONL lines ``{"x": [...], "y": <label>}``), keeps a bounded
window of the freshest rows, and on a cadence (every
``tpu_online_refit_every`` rows and/or ``tpu_online_refit_every_s``
seconds) makes a refreshed model from the current model file alone:

- ``tpu_online_mode=refit``: the leaf refit over the frozen forest
  (``online/refit.py`` on the card), mixed by ``tpu_online_decay``;
- ``tpu_online_mode=continue``: ``tpu_online_trees`` new trees boosted in
  the model's own bin space (``online/binspace.py``; the wave grower, so
  K1 on the card).

Each refreshed version is pushed through the registry's ``POST
/models/{name}/swap``, so the canary gate and the post-swap watch stand
between a bad refresh and traffic: a poisoned refresh is a rejected swap.
A rejected or failed push leaves the previous model as the base of the
next refresh, and a failed refresh on the card is a failed refresh, never
a rerun on the host.

Fault points (``robust/faults.py``): ``online_ingest`` on every ingest
batch, ``online_refit`` at the top of a refresh, ``online_swap`` before
the push.  Telemetry: one ``online_refresh`` event per cadence firing,
skipped ones included (an ingest stall is an event, not silence).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from .. import obs
from ..robust import faults
from ..utils import log


def _knob(config, name, cast, default, env=None):
    """A config attribute (or dict entry) with an optional environment
    override, which wins (as the serving knobs' do)."""
    if isinstance(config, dict):
        v = config.get(name, default)
    else:
        v = getattr(config, name, default) if config is not None else default
    if env:
        raw = os.environ.get(env, "")
        if raw:
            try:
                return cast(raw)
            except ValueError:
                log.warning("ignoring non-numeric %s=%r", env, raw)
    try:
        return cast(v)
    except (TypeError, ValueError):
        return default


def read_label_stream(path: str, follow: bool = False,
                      poll_s: float = 0.2, batch_rows: int = 256,
                      stop: Optional[Callable[[], bool]] = None
                      ) -> Iterator[Optional[Tuple[np.ndarray, np.ndarray]]]:
    """Yield ``(X, y)`` batches of a JSONL prediction+label stream.

    Each line is ``{"x": [floats], "y": label}`` (``"features"`` and
    ``"label"`` are synonyms).  Malformed lines (bad JSON, non-numeric
    fields, or a width other than the stream's first row's) are counted
    and skipped.  ``follow=True`` tails the file for appended lines and
    ends only when ``stop()`` says so; while idle it yields ``None``
    heartbeats each poll, so the consumer's time cadence (and its
    ingest-stall skip) keeps firing with no data flowing.  A trailing
    line written only in part (no newline yet) is held and joined with
    the next read, never parsed as two fragments."""
    rows, labels, bad = [], [], 0
    width = None
    pending = ""

    def flush():
        nonlocal rows, labels
        if not rows:
            return None
        out = (np.asarray(rows, np.float64), np.asarray(labels, np.float64))
        rows, labels = [], []
        return out

    def parse(line):
        nonlocal bad, width
        line = line.strip()
        if not line:
            return
        try:
            rec = json.loads(line)
            x = [float(v) for v in rec.get("x", rec.get("features"))]
            y = float(rec.get("y", rec.get("label")))
        except (ValueError, TypeError, AttributeError):
            bad += 1
            return
        if width is None:
            width = len(x)
        elif len(x) != width:
            bad += 1
            return
        rows.append(x)
        labels.append(y)

    with open(path) as fh:
        while True:
            chunk = fh.readline()
            if not chunk:
                batch = flush()
                if batch is not None:
                    yield batch
                if not follow or (stop is not None and stop()):
                    break
                time.sleep(poll_s)
                yield None   # heartbeat: the consumer's cadence ticks
                continue
            if follow and not chunk.endswith("\n"):
                pending += chunk     # a feeder's write landed mid-line
                continue
            parse(pending + chunk)
            pending = ""
            if len(rows) >= batch_rows:
                yield flush()
    if pending:
        parse(pending)
        batch = flush()
        if batch is not None:
            yield batch
    if bad:
        log.warning("label stream %s: skipped %d malformed line(s)",
                    path, bad)


class OnlineLoop:
    """Bounded-window ingest, cadence-driven refresh, registry push.

    ``push`` is ``(model_path) -> report dict`` (the HTTP ``POST
    /models/{name}/swap`` of ``run_online``, or ``registry.swap`` in
    process) and must raise on a rejected swap.  The loop never dies for
    a failed refresh: the old model keeps serving and stays the base of
    the next one."""

    def __init__(self, model_file: str, config=None,
                 push: Optional[Callable[[str], dict]] = None,
                 workdir: Optional[str] = None,
                 params: Optional[dict] = None):
        self.base = str(model_file)
        self.config = config
        self.push = push
        self.params = dict(params or {})
        self.mode = str(_knob(config, "tpu_online_mode", str, "refit"))
        self.window_cap = max(int(_knob(config, "tpu_online_window", int,
                                        50000, "LGBM_TPU_ONLINE_WINDOW")), 1)
        self.refresh_rows = int(_knob(config, "tpu_online_refit_every", int,
                                      5000, "LGBM_TPU_ONLINE_REFIT_EVERY"))
        self.refresh_s = float(_knob(config, "tpu_online_refit_every_s",
                                     float, 0.0))
        self.trees = max(int(_knob(config, "tpu_online_trees", int, 10)), 1)
        decay = float(_knob(config, "tpu_online_decay", float, -1.0))
        self.decay = (decay if decay >= 0.0 else
                      float(_knob(config, "refit_decay_rate", float, 0.9)))
        self.workdir = workdir or tempfile.mkdtemp(prefix="lgbm_online_")
        os.makedirs(self.workdir, exist_ok=True)
        self._X: list = []          # the window's rows ([F] arrays)
        self._y: list = []
        self._rows_since = 0        # rows ingested since the last refresh
        self._last_refresh_t = time.monotonic()
        self.versions = 0           # successful pushes
        self.rejected = 0           # pushes the canary gate bounced
        self.failed = 0             # refreshes that died before the push
        self.skipped = 0            # cadence firings with no fresh rows
        self.rows_ingested = 0
        # serve/quality.py's tracker, set by run_online when the served
        # model has a quality sidecar: every labeled batch also feeds the
        # rolling per-version quality windows
        self.quality = None

    def ingest(self, X, y) -> int:
        """Append labeled rows to the window (the oldest fall out past
        ``tpu_online_window``).  Returns the rows taken."""
        faults.check("online_ingest")
        X = np.atleast_2d(np.asarray(X, np.float64))
        y = np.atleast_1d(np.asarray(y, np.float64))
        if X.shape[0] != y.shape[0]:
            raise ValueError("ingest rows/labels length mismatch")
        self._X.extend(X)
        self._y.extend(y)
        if len(self._X) > self.window_cap:
            drop = len(self._X) - self.window_cap
            del self._X[:drop]
            del self._y[:drop]
        self._rows_since += X.shape[0]
        self.rows_ingested += X.shape[0]
        if self.quality is not None:
            try:
                self.quality.add(X, y)
            except Exception as exc:  # noqa: BLE001 — quality tracking
                # never takes the ingest path down
                log.warning("online: quality window update failed: %s",
                            exc)
        return X.shape[0]

    def due(self, now: Optional[float] = None) -> bool:
        """Has the cadence fired?  The row and time cadences combine as
        OR; both off means never."""
        now = time.monotonic() if now is None else now
        if self.refresh_rows > 0 and self._rows_since >= self.refresh_rows:
            return True
        return (self.refresh_s > 0
                and now - self._last_refresh_t >= self.refresh_s)

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """Refresh when due; None when the cadence has not fired.  A due
        tick with no fresh rows is an ingest stall: the refresh is skipped
        with a warning and an event (refitting a stale window would pass
        old data off as fresh)."""
        if not self.due(now):
            return None
        if self._rows_since == 0 or not self._X:
            self.skipped += 1
            self._last_refresh_t = time.monotonic()
            log.warning("online: refresh cadence fired with no fresh rows "
                        "(ingest stall); skipping this cycle (the window "
                        "holds %d stale row(s))", len(self._X))
            obs.event("online_refresh", mode=self.mode, ok=False,
                      skipped="ingest_stall", rows=0)
            return {"ok": False, "skipped": "ingest_stall"}
        return self.refresh()

    def refresh(self) -> dict:
        """One refresh: refit or continue the current model file over the
        window, save the candidate, push it.  Never raises: the report
        (and the ``online_refresh`` event) carries the outcome."""
        t0 = time.perf_counter()
        rows = len(self._X)
        report = {"ok": False, "mode": self.mode, "rows": rows}
        attempt = self.versions + self.rejected + self.failed + 2
        out_path = os.path.join(self.workdir, f"model_v{attempt}.txt")
        try:
            faults.check("online_refit")
            Xw = np.asarray(self._X, np.float64)
            yw = np.asarray(self._y, np.float64)
            if self.mode == "continue":
                from .binspace import train_continue
                bst = train_continue(self.base, Xw, yw, params=self.params,
                                     num_boost_round=self.trees)
            else:
                from .binspace import refit_from_model
                bst = refit_from_model(self.base, Xw, yw,
                                       params=self.params,
                                       decay_rate=self.decay)
            bst.save_model(out_path)
            faults.check("online_swap")
            if self.push is not None:
                report["push"] = self.push(out_path)
            self.base = out_path        # adopted: the next refresh's base
            self.versions += 1
            report.update(ok=True, version=self.versions, path=out_path)
        except Exception as exc:  # noqa: BLE001 — a bad refresh is recorded
            # and the loop goes on from the old base; the canary gate has
            # already kept it from traffic
            import urllib.error

            from ..serve.registry import SwapRejected
            rejected = isinstance(exc, SwapRejected) or (
                isinstance(exc, urllib.error.HTTPError) and exc.code == 409)
            if rejected:
                self.rejected += 1
            else:
                self.failed += 1
            report["error"] = f"{type(exc).__name__}: {exc}"
            log.warning("online: refresh %s; the previous model keeps "
                        "serving and stays the refresh base (%s)",
                        "rejected by the canary gate" if rejected
                        else "FAILED", report["error"])
        ms = round((time.perf_counter() - t0) * 1e3, 1)
        report["ms"] = ms
        self._rows_since = 0
        self._last_refresh_t = time.monotonic()
        obs.event("online_refresh", mode=self.mode, ok=bool(report["ok"]),
                  rows=rows, ms=ms,
                  **({"version": self.versions} if report["ok"] else {}),
                  **({"error": report["error"][:200]}
                     if report.get("error") else {}))
        return report

    def stats(self) -> dict:
        out = {"mode": self.mode, "versions": self.versions,
               "rejected": self.rejected, "failed": self.failed,
               "skipped": self.skipped,
               "rows_ingested": self.rows_ingested,
               "window_rows": len(self._X), "base": self.base,
               "last_refresh_age_s": round(
                   time.monotonic() - self._last_refresh_t, 3)}
        if self.quality is not None:
            out["quality"] = self.quality.stats()
        return out


def run_online(cfg, params: dict, on_drained=None) -> dict:
    """``task=online``: serve ``input_model`` behind a registry fleet and
    feed the label stream back into it, in one process.  The push goes
    through the HTTP ``POST /models/{name}/swap`` of this process's own
    server, the path an outside pusher takes.  ``on_drained(loop,
    registry, server)``, when given, runs after the stream's last refresh
    and before the server stops (an embedding caller's last look at the
    live fleet).  Returns the loop's final ``stats()``."""
    import urllib.request

    from ..serve import ModelRegistry, PredictServer

    if not cfg.input_model:
        log.fatal("task=online needs input_model (alias: model_file)")
    source = cfg.tpu_online_source or cfg.data
    if not source:
        log.fatal("task=online needs a label stream: tpu_online_source "
                  "(or data) pointing at a JSONL file of "
                  '{"x": [...], "y": <label>} lines')
    name = cfg.tpu_online_model or "default"
    reg = ModelRegistry(config=cfg)
    try:
        reg.add_model(name, cfg.input_model)
        server = PredictServer(reg, host=cfg.tpu_serve_host,
                               port=cfg.tpu_serve_port).start()
    except BaseException:
        reg.close()
        raise

    def push(model_path: str) -> dict:
        req = urllib.request.Request(
            f"{server.url}/models/{name}/swap",
            data=json.dumps({"model_file": model_path}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())

    loop = OnlineLoop(cfg.input_model, config=cfg, push=push,
                      workdir=cfg.tpu_online_dir or None, params=dict(params))
    # the fleet /metrics renders these counters as the tpu_online_* series
    reg.online_provider = loop.stats
    from ..obs.drift import QualityProfile, profile_path
    prof_file = profile_path(cfg.input_model)
    if os.path.isfile(prof_file):
        try:
            from ..serve.quality import QualityTracker
            prof = QualityProfile.load(prof_file)
            loop.quality = QualityTracker(
                lambda X: reg.resolve(name).router.predict(X,
                                                           raw_score=True),
                prof, config=cfg, registry=reg, model_name=name)
            log.info("online: quality windows armed from %s (train_auc=%s)",
                     prof_file, prof.meta.get("train_auc"))
        except (ValueError, OSError) as exc:
            log.warning("online: quality profile unusable, windows "
                        "disarmed: %s", exc)
    log.info("online: serving %r on %s, ingesting %s (mode=%s, cadence "
             "%d rows / %gs, window %d)", name, server.url, source,
             loop.mode, loop.refresh_rows, loop.refresh_s, loop.window_cap)
    try:
        for batch in read_label_stream(source,
                                       follow=bool(cfg.tpu_online_follow)):
            if batch is not None:
                loop.ingest(*batch)
            # a heartbeat ticks too: the time cadence and the ingest-stall
            # skip fire while the stream is quiet
            loop.tick()
        if loop._rows_since > 0:
            loop.refresh()   # the tail of a finite stream counts
        if on_drained is not None:
            on_drained(loop, reg, server)
    except KeyboardInterrupt:
        log.warning("online: interrupted; shutting down")
    finally:
        st = loop.stats()
        log.info("online: %d refreshed version(s) pushed, %d rejected, "
                 "%d failed, %d skipped, %d row(s) ingested",
                 st["versions"], st["rejected"], st["failed"],
                 st["skipped"], st["rows_ingested"])
        server.stop(close_session=True)
    return st
