"""REST control API (counterpart of
``video_edge_ai_proxy_tpu/serve/rest_api.py``), on aiohttp.

Routes of the planes the port has, with the JAX server's payloads:

    POST   /api/v1/process            start a camera
    DELETE /api/v1/process/{name}     stop a camera
    GET    /api/v1/process/{name}     info (record, live state, log tail)
    GET    /api/v1/process/{name}/logs?since=N   incremental log tail
    GET    /api/v1/processlist        list cameras
    GET    /api/v1/settings           edge credentials
    POST   /api/v1/settings           overwrite edge credentials
    GET    /api/v1/stats              engine, uplink and registry view
    GET    /api/v1/slo                SLO burn state
    GET    /api/v1/quality            quality verdicts
    GET    /api/v1/router             degradation-ladder rung
    GET    /api/v1/hbm                device-memory plane (program
                                      footprints, pools, forecast)
    GET    /api/v1/cascade            temporal cascade (cadence, tracks,
                                      events, the state pool)
    GET    /api/v1/journal            decision journal (?actor= ?action=
                                      ?subject=kind[:id] ?since=seq ?limit=n)
    GET    /api/v1/why                causal chain (?stream=S, ?member=M or
                                      ?subject=kind:id; ?max_links=n)
    GET    /api/v1/trace              lineage spans and stage breakdown
                                      (?stream= ?limit= ?format=chrome)
    GET|POST /api/v1/profile?ms=N     bounded torch.profiler capture ->
                                      the bundle manifest
    POST   /api/v1/profile/start      unbounded trace ({"log_dir": ...})
    POST   /api/v1/profile/stop
    GET    /healthz                   liveness (503 when degraded)
    GET    /metrics                   Prometheus text
    OPTIONS /api/v1/...               CORS preflight

CORS is wide open like the reference; errors use its JSON envelope
(``{"code", "message"}``). A plane that is switched off answers 400, a
capture out of (0, ``prof_max_ms``] answers 400 and a second capture in
flight 409. The routes of planes not ported (capacity,
faults, fleet, router attach/detach, supervisor, rtspscan, the portal)
are absent. Served on a thread of its own with its own event
loop. Imports ``aiohttp``: only ``Server.start`` imports this module.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import tempfile
import threading
from typing import Optional

from aiohttp import web

from ..obs import registry as obs_registry
from ..obs.spans import stage_breakdown, to_chrome_trace, tracer
from .models import RTMPStreamStatus, StreamProcess
from .process_manager import ProcessError, ProcessManager
from .settings import SettingsManager

log = logging.getLogger("vep.torch.serve.rest")

ANNOTATION_POLICIES = ("", "all", "keyframe", "on_change", "min_interval")


def _error(status: int, message: str) -> web.Response:
    return web.json_response({"code": status, "message": message}, status=status)


def _to_dict(obj) -> dict:
    def drop_none(o):
        if isinstance(o, dict):
            return {k: drop_none(v) for k, v in o.items() if v is not None}
        return o

    return drop_none(dataclasses.asdict(obj))


_CORS = {"Access-Control-Allow-Origin": "*", "Access-Control-Allow-Methods": "*",
         "Access-Control-Allow-Headers": "*", "Access-Control-Allow-Credentials": "true"}


@web.middleware
async def _cors(request: web.Request, handler):
    if request.method == "OPTIONS":
        resp = web.Response(status=204)
    else:
        try:
            resp = await handler(request)
        except web.HTTPException as exc:
            # 404s and other raised statuses carry the CORS headers too.
            exc.headers.update(_CORS)
            raise
    resp.headers.update(_CORS)
    return resp


def build_app(pm: ProcessManager, settings: SettingsManager, engine=None,
              annotations=None) -> web.Application:
    app = web.Application(middlewares=[_cors], client_max_size=8 << 20)

    async def start_process(request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        if not body.get("rtsp_endpoint"):
            return _error(400, "RTP endpoint required")
        policy = body.get("annotation_policy", "")
        if policy not in ANNOTATION_POLICIES:
            # Rejected here, not warned per frame in the engine: a typo'd
            # policy would otherwise fall back to the "all" firehose.
            return _error(400, f"unknown annotation_policy {policy!r}")
        record = StreamProcess(
            name=body.get("name", ""),
            image_tag=body.get("image_tag", ""),
            rtsp_endpoint=body["rtsp_endpoint"],
            rtmp_endpoint=body.get("rtmp_endpoint", ""),
            rtmp_stream_status=RTMPStreamStatus(streaming=True, storing=False),
            inference_model=body.get("inference_model", ""),
            annotation_policy=policy,
        )
        try:
            await asyncio.to_thread(pm.start, record)
        except ProcessError as exc:
            return _error(409, str(exc))
        return web.Response(status=200)

    async def stop_process(request: web.Request) -> web.Response:
        try:
            await asyncio.to_thread(pm.stop, request.match_info["name"])
        except ProcessError as exc:
            return _error(409, str(exc))
        return web.Response(status=200)

    async def process_info(request: web.Request) -> web.Response:
        try:
            record = await asyncio.to_thread(pm.info, request.match_info["name"])
        except ProcessError as exc:
            return _error(400, str(exc))
        return web.json_response(_to_dict(record))

    async def process_list(_request: web.Request) -> web.Response:
        records = await asyncio.to_thread(pm.list)
        return web.json_response([_to_dict(r) for r in records])

    async def process_logs(request: web.Request) -> web.Response:
        """``?since=<total of the last reply>`` returns only the lines
        appended since (the portal's live follow)."""
        try:
            since = int(request.query.get("since", "0"))
        except ValueError:
            return _error(400, "since must be an integer")
        try:
            out = await asyncio.to_thread(pm.logs_since, request.match_info["name"], since)
        except ProcessError as exc:
            return _error(400, str(exc))
        return web.json_response(out)

    async def settings_get(_request: web.Request) -> web.Response:
        return web.json_response(_to_dict(await asyncio.to_thread(settings.get)))

    async def settings_overwrite(request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        s = await asyncio.to_thread(settings.overwrite, body.get("edge_key", ""),
                                    body.get("edge_secret", ""))
        return web.json_response(_to_dict(s))

    async def stats(_request: web.Request) -> web.Response:
        out: dict = {"engine": None, "annotation_queue": None}
        if engine is not None:
            out["engine"] = {
                "model": engine._spec.name,
                "ticks": engine.ticks,
                "batches": engine.pipeline_stats().batches,
                "subscriber_drops": engine.subscriber_drops,
                "streams": {did: dataclasses.asdict(st) for did, st in engine.stats().items()},
                "prewarm": engine.prewarm_status(),
                "annotations_suppressed": engine.annotations_suppressed,
            }
        if annotations is not None:
            out["annotation_queue"] = {
                "depth": annotations.depth(),
                "published": annotations.published,
                "acked": annotations.acked,
                "dropped": annotations.dropped,
                "rejected_batches": annotations.rejected_batches,
            }
        out["obs"] = {
            "metrics": obs_registry.snapshot(),
            "watch": engine.watchdog.snapshot() if engine is not None else None,
            "trace": {"enabled": tracer.enabled, "sample_every": tracer.sample_every,
                      "streams": tracer.streams()},
            "perf": engine.perf.snapshot() if engine is not None else None,
            "slo": engine.slo.snapshot() if engine is not None and engine.slo is not None
            else None,
            "prof": engine.prof.snapshot()
            if engine is not None and engine.prof is not None else None,
            "quality": engine.quality.snapshot()
            if engine is not None and engine.quality is not None else None,
            "journal": engine.journal.snapshot(tail=32)
            if engine is not None and engine.journal is not None else None,
            # The same snapshot /api/v1/hbm serves.
            "hbm": engine.hbm.snapshot()
            if engine is not None and engine.hbm is not None else None,
            # The same snapshot /api/v1/cascade serves.
            "cascade": engine.cascade.snapshot()
            if engine is not None and engine.cascade is not None else None,
        }
        return web.json_response(out)

    async def cascade(_request: web.Request) -> web.Response:
        """The temporal cascade (temporal/scheduler.py): the head's cadence,
        each track's score and state, the pool's occupancy, recent events;
        400 when it is off (engine.cascade config)."""
        if engine is None:
            return _error(400, "engine not running")
        if engine.cascade is None:
            return _error(400, "cascade disabled (engine.cascade config)")
        out = await asyncio.to_thread(engine.cascade.snapshot)
        return web.json_response(out)

    async def hbm(_request: web.Request) -> web.Response:
        """The device-memory plane (obs/hbm.py); 400 when it is off
        (engine.hbm config)."""
        if engine is None:
            return _error(400, "engine not running")
        if engine.hbm is None:
            return _error(400, "hbm plane disabled (engine.hbm config)")
        out = await asyncio.to_thread(engine.hbm.snapshot)
        return web.json_response(out)

    async def slo(_request: web.Request) -> web.Response:
        if engine is None:
            return _error(400, "engine not running")
        if engine.slo is None:
            return _error(400, "SLO engine disabled (engine.slo config)")
        return web.json_response(engine.slo.snapshot())

    async def quality(_request: web.Request) -> web.Response:
        if engine is None:
            return _error(400, "engine not running")
        if engine.quality is None:
            return _error(400, "quality tracking disabled (engine.quality config)")
        out = await asyncio.to_thread(engine.quality.snapshot)
        out["canary"] = engine.canary.snapshot() if engine.canary is not None else None
        return web.json_response(out)

    async def router_state(_request: web.Request) -> web.Response:
        if engine is None:
            return _error(400, "engine not running")
        if engine.ladder is None:
            return _error(400, "degradation ladder disabled (engine.ladder config)")
        return web.json_response(engine.ladder.snapshot())

    async def journal(request: web.Request) -> web.Response:
        """Retained decision events oldest to newest, filtered by
        ``?actor=``, ``?action=``, ``?subject=kind:id`` (or a bare kind),
        ``?since=seq`` (exclusive) and ``?limit=n`` (the newest n)."""
        if engine is None:
            return _error(400, "engine not running")
        if engine.journal is None:
            return _error(400, "decision journal disabled (engine.journal config)")
        q = request.query
        subject = subject_kind = None
        raw = q.get("subject")
        if raw:
            kind, sep, ident = raw.partition(":")
            if sep:
                subject = (kind, ident)
            else:
                subject_kind = kind
        try:
            since = int(q["since"]) if "since" in q else None
            limit = int(q["limit"]) if "limit" in q else None
        except ValueError:
            return _error(400, "since/limit must be integers")
        events = await asyncio.to_thread(
            engine.journal.events, subject=subject, subject_kind=subject_kind,
            actor=q.get("actor") or None, action=q.get("action") or None,
            since=since, limit=limit)
        return web.json_response({"next_seq": engine.journal.next_seq, "events": events})

    async def why(request: web.Request) -> web.Response:
        """The causal chain behind a subject's state: its newest journal
        event and the cause links walked back, root first."""
        if engine is None:
            return _error(400, "engine not running")
        if engine.journal is None:
            return _error(400, "decision journal disabled (engine.journal config)")
        q = request.query
        if "stream" in q:
            kind, ident = "stream", q["stream"]
        elif "member" in q:
            kind, ident = "member", q["member"]
        elif "subject" in q and ":" in q["subject"]:
            kind, _, ident = q["subject"].partition(":")
        else:
            return _error(400, "pass ?stream=S, ?member=M, or ?subject=kind:id")
        try:
            max_links = int(q.get("max_links", "8"))
        except ValueError:
            return _error(400, "max_links must be an integer")
        out = await asyncio.to_thread(engine.journal.why, kind, ident, max_links=max_links)
        return web.json_response(out)

    async def trace(request: web.Request) -> web.Response:
        """Buffered lineage spans and their per-leg breakdown, or
        (``?format=chrome``) Chrome trace-event JSON."""
        stream = request.query.get("stream")
        try:
            limit = int(request.query.get("limit", "0")) or None
        except ValueError:
            return _error(400, "limit must be an integer")
        events = tracer.events(stream=stream, limit=limit)
        if request.query.get("format") == "chrome":
            return web.json_response(to_chrome_trace(events))
        return web.json_response({"enabled": tracer.enabled,
                                  "sample_every": tracer.sample_every,
                                  "events": events, "breakdown": stage_breakdown(events)})

    async def profile_capture(request: web.Request) -> web.Response:
        """A bounded capture of ``?ms=N`` (default 500): the bundle
        manifest. 400 when profiling is off or the duration is out of
        range, 409 when a capture is in flight."""
        if engine is None:
            return _error(400, "engine not running")
        if engine.prof is None:
            return _error(400, "profiling disabled (engine.prof config)")
        try:
            ms = int(request.query.get("ms", "500"))
        except ValueError:
            return _error(400, "ms must be an integer")
        try:
            manifest = await asyncio.to_thread(engine.prof.capture, ms, trigger="manual",
                                               context={"via": "rest"})
        except ValueError as exc:
            return _error(400, str(exc))
        except RuntimeError as exc:
            return _error(409, str(exc))
        return web.json_response(manifest)

    async def profile_start(request: web.Request) -> web.Response:
        """An unbounded trace (the start/stop pair), on the same busy
        flag as the bounded captures."""
        if engine is None:
            return _error(400, "engine not running")
        if engine.prof is None:
            return _error(400, "profiling disabled (engine.prof config)")
        try:
            body = await request.json()
        except Exception:
            body = {}
        if not isinstance(body, dict):
            return _error(400, "JSON object body expected")
        log_dir = body.get("log_dir") or os.path.join(tempfile.gettempdir(), "vep_tpu_profile")
        try:
            await asyncio.to_thread(engine.start_profile, log_dir)
        except RuntimeError as exc:
            return _error(409, str(exc))
        return web.json_response({"log_dir": log_dir})

    async def profile_stop(_request: web.Request) -> web.Response:
        if engine is None:
            return _error(400, "engine not running")
        if engine.prof is None:
            return _error(400, "profiling disabled (engine.prof config)")
        try:
            await asyncio.to_thread(engine.stop_profile)
        except RuntimeError as exc:
            return _error(409, str(exc))
        return web.Response(status=200)

    def _sync_scrape_families() -> str:
        """Mirror control-plane state the registry cannot observe live (the
        worker fleet, the annotation queue, tripped models) into families,
        then render the registry. Per-entity families are cleared first so
        a removed camera or a recovered model stops exporting."""
        procs = pm.list()
        obs_registry.gauge("vep_workers_total", "Registered camera workers").set(len(procs))
        obs_registry.gauge("vep_workers_running", "Camera workers currently running").set(
            sum(1 for p in procs if p.state and p.state.running))
        streaks = obs_registry.gauge("vep_worker_failing_streak",
                                     "Consecutive failures per worker", ("stream",))
        streaks.clear()
        for p in procs:
            if p.state:
                streaks.labels(p.name).set(p.state.failing_streak)
        if engine is not None:
            obs_registry.counter(
                "vep_subscriber_dropped_total",
                "Inference results dropped on slow subscribers",
            ).labels().set(engine.subscriber_drops)
            disabled = obs_registry.gauge(
                "vep_model_disabled",
                "Per-stream models tripped by the failure breaker (value 1 while disabled)",
                ("model",))
            disabled.clear()
            for name in list(engine._bad_models):
                disabled.labels(name).set(1)
        if annotations is not None:
            obs_registry.gauge("vep_annotation_queue_depth",
                               "Annotation uplink queue depth").set(annotations.depth())
            obs_registry.counter("vep_annotations_published_total",
                                 "Annotations enqueued").labels().set(annotations.published)
            obs_registry.counter("vep_annotations_acked_total",
                                 "Annotation batches acked by the cloud").labels().set(
                annotations.acked)
            obs_registry.counter("vep_annotations_dropped_total",
                                 "Annotations dropped at the unacked limit").labels().set(
                annotations.dropped)
            obs_registry.counter("vep_annotation_rejected_batches_total",
                                 "Annotation batches rejected by the cloud (re-queued)"
                                 ).labels().set(annotations.rejected_batches)
            if engine is not None:
                obs_registry.counter(
                    "vep_annotations_suppressed_total",
                    "Annotations withheld by the emit policy (engine.annotation_emit) "
                    "before reaching the queue").labels().set(engine.annotations_suppressed)
        return obs_registry.render()

    async def metrics(_request: web.Request) -> web.Response:
        text = await asyncio.to_thread(_sync_scrape_families)
        return web.Response(text=text, content_type="text/plain", charset="utf-8")

    async def healthz(_request: web.Request) -> web.Response:
        """200 unless the engine is unhealthy or the whole registered fleet
        is down and failing (a camera outage alone does not degrade it)."""
        procs = await asyncio.to_thread(pm.list)
        running = sum(1 for p in procs if p.state and p.state.running)
        crash_looping = sum(
            1 for p in procs
            if p.state and not p.state.running
            and (p.state.failing_streak > 1 or p.state.dead))
        body: dict = {
            "status": "ok",
            "workers": {"running": running, "total": len(procs),
                        "crash_looping": crash_looping,
                        "fleet": "degraded" if crash_looping else "ok"},
            "engine": None,
        }
        healthy = not (len(procs) > 0 and running == 0 and crash_looping == len(procs))
        if engine is not None:
            h = await asyncio.to_thread(engine.health)
            body["engine"] = h
            healthy = healthy and h["ok"]
        if not healthy:
            body["status"] = "degraded"
        return web.json_response(body, status=200 if healthy else 503)

    async def options(_request: web.Request) -> web.Response:
        return web.Response(status=204)

    app.router.add_post("/api/v1/process", start_process)
    app.router.add_delete("/api/v1/process/{name}", stop_process)
    app.router.add_get("/api/v1/process/{name}", process_info)
    app.router.add_get("/api/v1/process/{name}/logs", process_logs)
    app.router.add_get("/api/v1/processlist", process_list)
    app.router.add_get("/api/v1/settings", settings_get)
    app.router.add_post("/api/v1/settings", settings_overwrite)
    app.router.add_get("/api/v1/stats", stats)
    app.router.add_get("/api/v1/slo", slo)
    app.router.add_get("/api/v1/quality", quality)
    app.router.add_get("/api/v1/router", router_state)
    app.router.add_get("/api/v1/hbm", hbm)
    app.router.add_get("/api/v1/cascade", cascade)
    app.router.add_get("/api/v1/journal", journal)
    app.router.add_get("/api/v1/why", why)
    app.router.add_get("/api/v1/trace", trace)
    app.router.add_get("/api/v1/profile", profile_capture)
    app.router.add_post("/api/v1/profile", profile_capture)
    app.router.add_post("/api/v1/profile/start", profile_start)
    app.router.add_post("/api/v1/profile/stop", profile_stop)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/metrics", metrics)
    app.router.add_route("OPTIONS", "/api/v1/{tail:.*}", options)
    return app


class RestServer:
    """The aiohttp app on a thread of its own; start/stop from the caller."""

    def __init__(self, pm: ProcessManager, settings: SettingsManager,
                 host: str = "0.0.0.0", port: int = 8080, engine=None, annotations=None):
        self._app = build_app(pm, settings, engine=engine, annotations=annotations)
        self._host = host
        self._port = port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self.bound_port: int = port

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="rest-api", daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=15):
            raise RuntimeError("REST server failed to start")

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(self._app)

        async def serve():
            await runner.setup()
            site = web.TCPSite(runner, self._host, self._port)
            await site.start()
            server = site._server  # the bound socket (port 0 -> ephemeral)
            if server and server.sockets:
                self.bound_port = server.sockets[0].getsockname()[1]
            log.info("REST API listening on %s:%d", self._host, self.bound_port)
            self._started.set()

        loop.run_until_complete(serve())
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(runner.cleanup())
            loop.close()

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5)
