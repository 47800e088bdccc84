"""Server entry point (counterpart of ``video_edge_ai_proxy_tpu/serve/server.py``):
wires the registry, the bus, the camera process manager, the cron, the
annotation uplink, the inference engine and the REST and gRPC wire.

    python -m video_edge_ai_proxy_tpu_torch.serve.server --conf conf.yaml \\
        --data_dir /data/chrysalis --engine

Boot order as in the JAX server: registry resume (cameras restart, or are
re-adopted with ``worker_adoption``), cron, the annotation consumer, REST,
the engine, gRPC. Stop order: gRPC, REST, the engine, the uplink, the
cron, then the workers are detached (``worker_adoption``: they keep
publishing and the next boot re-adopts them) or stopped, and the bus and
the registry are closed.

With ``bus.backend: redis`` the bus is the reference's Redis wire
(``bus/redis_bus.py`` at ``bus.redis_addr``), the workers get the same
address, and annotations queue in that Redis (``uplink/redis_queue.py``,
the reference's rmq layout) instead of in memory.

The engine runs on the card (``device="cuda"``) unless the caller asks
for the CPU. It takes its per-stream model and annotation policy from the
process manager's registry records. The process's decision journal
(``engine.journal``) is built here and shared with the engine; the lineage
tracer is process-global and configured from ``obs`` (``trace``,
``sample_every``, ``trace_ring``); the profiler's bundles go under
``<data_dir>/prof`` unless ``engine.prof_dir`` says otherwise; with
``engine.cascade`` on, the cascade's enter events archive their clips
under ``<data_dir>/cascade_clips`` (``ingest/archive.py``).

``Server.__init__`` and every plane but the wire import neither ``grpc``,
``google.protobuf`` nor ``aiohttp`` (nor ``yaml``, unless ``load_config``
reads a file); ``start()`` imports the wire modules first and raises their
``ImportError`` before it starts anything: there is no server without its
wire. The persistent XLA compile cache of the JAX server has no
counterpart: ``engine.compile_cache_dir`` stays off, with a log line.

The fleet tier as in the JAX server: ``obs.instance`` labels every
``/metrics`` sample; ``obs.fleet_members`` runs a ``FleetAggregator`` in
this process (``/api/v1/fleet/*``); ``supervisor.enabled`` with
``router.members`` runs a ``StreamRouter`` and an advisory
``FleetSupervisor`` here (``/api/v1/supervisor``), the router attaching to
its members (which arms each member's ``shed_to_fleet`` rung through
``/api/v1/router/attach``).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import signal
import threading
from typing import Optional

from ..bus import open_bus
from ..resilience.spool import DeadLetterSpool
from ..uplink import AnnotationQueue, make_batch_handler
from ..utils.config import Config, load_config
from .cron import CronJobs
from .process_manager import ProcessManager
from .settings import SettingsManager
from .storage import Storage

log = logging.getLogger("vep.torch.serve.server")

# (config switch, what stays off) for the JAX server's planes the port
# lacks; a YAML file may set them, and the server says it ignores them.
_NOT_PORTED = (
    ("engine.compile_cache_dir", "the persistent XLA compile cache (no counterpart)"),
)


def make_admin_handler(engine):
    """gRPC admin mirror of REST endpoints, JSON bytes in and out:
    ``/vep.Admin/ProfileCapture`` (``b'{"ms": 500}'`` -> the bundle
    manifest, = ``POST /api/v1/profile?ms=N``), ``/vep.Admin/Quality`` (=
    ``GET /api/v1/quality``) and ``/vep.Admin/RouterState`` (= ``GET
    /api/v1/router``). Status codes mirror REST: INVALID_ARGUMENT for a bad
    body or duration (400), FAILED_PRECONDITION for a plane switched off
    (the 400 of a disabled endpoint), ABORTED for a capture already in
    flight (409). Imports ``grpc``."""
    import json

    import grpc

    def profile_capture(request: bytes, context):
        if engine is None or engine.prof is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "profiling disabled (engine.prof config)")
        try:
            body = json.loads(request) if request else {}
            ms = int(body.get("ms", 500)) if isinstance(body, dict) else None
        except (ValueError, TypeError):
            ms = None
        if ms is None:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          'expected a JSON object body like {"ms": 500}')
        try:
            manifest = engine.prof.capture(ms, trigger="manual", context={"via": "grpc"})
        except ValueError as exc:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        except RuntimeError as exc:
            context.abort(grpc.StatusCode.ABORTED, str(exc))
        return json.dumps(manifest).encode()

    def quality(request: bytes, context):
        if engine is None or engine.quality is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "quality tracking disabled (engine.quality config)")
        out = engine.quality.snapshot()
        out["canary"] = engine.canary.snapshot() if engine.canary is not None else None
        return json.dumps(out).encode()

    def router_state(request: bytes, context):
        if engine is None or engine.ladder is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "degradation ladder disabled (engine.ladder config)")
        return json.dumps(engine.ladder.snapshot()).encode()

    def _rpc(fn):
        return grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=lambda b: b, response_serializer=lambda b: b)

    return grpc.method_handlers_generic_handler(
        "vep.Admin", {"ProfileCapture": _rpc(profile_capture), "Quality": _rpc(quality),
                      "RouterState": _rpc(router_state)})


class Server:
    def __init__(self, cfg: Optional[Config] = None, *, data_dir: str = "/data/chrysalis",
                 enable_engine: bool = False, grpc_port: Optional[int] = None,
                 rest_port: Optional[int] = None, device: str = "cuda"):
        self.cfg = cfg or load_config()
        self.data_dir = data_dir
        backend = self.cfg.bus.backend
        if self.cfg.runner.kind != "subprocess":
            raise ValueError(f"runner.kind={self.cfg.runner.kind!r}: the port runs "
                             "'subprocess' workers (the container runner is not ported)")
        for switch, what in _NOT_PORTED:
            log.info("%s stays off: not ported (%s)", what, switch)
        # Lineage tracing is process-global (obs.tracer): the engine and
        # the collector stamp into the same rings.
        from ..obs import tracer

        tracer.configure(enabled=self.cfg.obs.trace, sample_every=self.cfg.obs.sample_every,
                         ring=self.cfg.obs.trace_ring)
        # The fleet identity: a constant label at render time only.
        if self.cfg.obs.instance:
            from ..obs import registry as obs_registry

            obs_registry.set_const_labels(instance=self.cfg.obs.instance)
        self.fleet = None
        if self.cfg.obs.fleet_members:
            from ..obs.fleet import FleetAggregator

            self.fleet = FleetAggregator(
                self.cfg.obs.fleet_members, scrape_interval_s=self.cfg.obs.fleet_scrape_s,
                stale_after_s=self.cfg.obs.fleet_stale_s or None)
        # One decision journal per process, shared by the engine, the
        # router and the supervisor; engine.journal=False is the
        # process-wide kill switch.
        self.journal = None
        if self.cfg.engine.journal:
            from ..obs.journal import DecisionJournal

            self.journal = DecisionJournal(self.cfg.engine.journal_capacity)
        # The supervisor runs advisory here (no spawner comes from YAML):
        # its decisions show in /api/v1/supervisor and vep_supervisor_*.
        # It acts only through a router, so it needs router.members.
        self.router = None
        self.supervisor = None
        if self.cfg.supervisor.enabled:
            if not self.cfg.router.members:
                log.warning("supervisor.enabled with no router.members: nothing to "
                            "supervise; the supervisor stays off")
            else:
                from .router import StreamRouter
                from .supervisor import FleetSupervisor

                rc = self.cfg.router
                sup = self.cfg.supervisor
                self.router = StreamRouter(
                    rc.members, scrape_interval_s=rc.scrape_interval_s, base_vnodes=rc.vnodes,
                    max_moves_per_pass=rc.max_moves_per_pass,
                    min_healthy_age_s=rc.min_healthy_age_s, drain_timeout_s=rc.drain_timeout_s,
                    ema_alpha=rc.ema_alpha, healthy_above=rc.healthy_above,
                    unhealthy_below=rc.unhealthy_below, journal=self.journal)
                self.supervisor = FleetSupervisor(
                    self.router, min_members=sup.min_members, max_members=sup.max_members,
                    decision_interval_s=sup.decision_interval_s,
                    spawn_horizon_s=sup.spawn_horizon_s, surplus_headroom=sup.surplus_headroom,
                    surplus_hold_s=sup.surplus_hold_s, spawn_cooldown_s=sup.spawn_cooldown_s,
                    retire_cooldown_s=sup.retire_cooldown_s)
        self.storage = Storage(os.path.join(data_dir, "registry.db"))
        self.bus = open_bus(backend, self.cfg.bus.shm_dir, self.cfg.bus.redis_addr,
                            self.cfg.bus.redis_password, self.cfg.bus.redis_db)
        self.settings = SettingsManager(self.storage)
        self.process_manager = ProcessManager(
            self.storage, self.bus,
            shm_dir=self.cfg.bus.shm_dir,
            disk_buffer_path=(self.cfg.buffer.on_disk_folder if self.cfg.buffer.on_disk
                              else ""),
            bus_backend=backend,
            redis_addr=self.cfg.bus.redis_addr,
            redis_password=self.cfg.bus.redis_password,
            redis_db=self.cfg.bus.redis_db,
            # Adoption mode: camera pipelines survive a control-plane
            # restart (workers log to files, resume() re-attaches).
            log_dir=(os.path.join(data_dir, "worker_logs") if self.cfg.worker_adoption
                     else ""),
        )
        # Batches that exhaust the uplink's retries persist under the data
        # dir and drain again once it heals.
        ann = self.cfg.annotation
        spool_dir = ann.spool_dir or os.path.join(data_dir, "annotation_spool")
        ann_kwargs = dict(
            handler=make_batch_handler(
                self.settings, ann.endpoint,
                spool=DeadLetterSpool(spool_dir, max_bytes=ann.spool_max_bytes)),
            max_batch_size=ann.max_batch_size,
            poll_duration_ms=ann.poll_duration_ms,
            unacked_limit=ann.unacked_limit,
        )
        if backend == "redis":
            # The deployment that has a Redis keeps its annotations there:
            # unacked events survive a server restart (the reference's rmq
            # queue, uplink/redis_queue.py).
            from ..uplink.redis_queue import RedisAnnotationQueue

            self.annotations = RedisAnnotationQueue(
                addr=self.cfg.bus.redis_addr, password=self.cfg.bus.redis_password,
                db=self.cfg.bus.redis_db, **ann_kwargs)
        else:
            self.annotations = AnnotationQueue(**ann_kwargs)
        self.engine = None
        self._cascade_archiver = None
        if enable_engine:
            from ..engine.runner import InferenceEngine

            engine_cfg = self.cfg.engine
            if engine_cfg.aot_cache and engine_cfg.aot_cache_dir in ("", "auto"):
                # The prewarm manifest persists under the data dir, like
                # the registry, without changing the caller's Config.
                engine_cfg = dataclasses.replace(
                    engine_cfg, aot_cache_dir=os.path.join(data_dir, "aot_cache"))
            if engine_cfg.prof and not engine_cfg.prof_dir:
                # Capture bundles persist next to the rest of the state.
                engine_cfg = dataclasses.replace(
                    engine_cfg, prof_dir=os.path.join(data_dir, "prof"))
            if engine_cfg.cascade:
                # The enter events' clips, next to the rest of the state.
                from ..ingest.archive import SegmentArchiver

                self._cascade_archiver = SegmentArchiver(os.path.join(data_dir, "cascade_clips"))
            self.engine = InferenceEngine(
                self.bus, engine_cfg, device=device, annotations=self.annotations,
                model_resolver=self.process_manager.inference_model_of,
                annotation_policy_resolver=self.process_manager.annotation_policy_of,
                journal=self.journal, archiver=self._cascade_archiver,
            )
            if self.engine.slo is not None:
                for name, state in sorted(self.engine.slo.snapshot()["slos"].items()):
                    log.info("SLO %s: %s (objective %.3g, fire burn > %.3g, windows %gs/%gs)",
                             name, state["description"], state["objective"],
                             state["fire_burn_rate"], state["windows_s"]["fast"],
                             state["windows_s"]["slow"])
        self.cron = CronJobs(self.cfg.buffer)
        self._grpc_port = grpc_port if grpc_port is not None else self.cfg.grpc_port
        self._rest_port = rest_port if rest_port is not None else self.cfg.port
        self._grpc_server = None
        self._rest = None
        self._stopped = threading.Event()
        self.bound_grpc_port = self._grpc_port

    def start(self) -> None:
        # gRPC's fork handlers run in every child this process forks (the
        # camera workers, which exec at once): with another thread inside
        # gRPC they aborted a forked worker (SIGABRT, "Check failed:
        # next_worker->initialized_cv"; 4 of about 20 worker starts in
        # member servers on the card). The workers use no gRPC, so the
        # handlers are off unless the environment says otherwise; read
        # when gRPC first initialises in the process.
        os.environ.setdefault("GRPC_ENABLE_FORK_SUPPORT", "false")
        # The wire's packages first: without them nothing starts.
        import grpc
        from concurrent import futures

        from ..proto import video_streaming_pb2_grpc as pb_grpc
        from .grpc_api import ImageServicer
        from .rest_api import RestServer

        resumed = self.process_manager.resume()
        if resumed:
            log.info("resumed %d cameras from registry", resumed)
        self.cron.start()
        self.annotations.start()
        if self._cascade_archiver is not None:
            self._cascade_archiver.start()
        # REST binds before the engine prewarms: the server answers during
        # the compile ramp (prewarm incomplete in /api/v1/stats).
        self._rest = RestServer(self.process_manager, self.settings, port=self._rest_port,
                                engine=self.engine, annotations=self.annotations,
                                fleet=self.fleet, supervisor=self.supervisor)
        self._rest.start()
        if self.engine is not None:
            self.engine.start()
        if self.fleet is not None:
            self.fleet.start()
            log.info("fleet aggregator scraping %d members every %gs "
                     "(/api/v1/fleet/stats, /api/v1/fleet/metrics)",
                     len(self.cfg.obs.fleet_members), self.fleet.scrape_interval_s)
        if self.router is not None:
            # Arm shed_to_fleet on the reachable members (per-member errors
            # are recorded, not fatal) and start the placement loop.
            self.router.attach()
            self.router.start()
        if self.supervisor is not None:
            self.supervisor.start()
            log.info("fleet supervisor (advisory) over %d members: bounds [%d, %d], "
                     "decision every %gs (/api/v1/supervisor)", len(self.router.clients),
                     self.supervisor.min_members, self.supervisor.max_members,
                     self.supervisor.decision_interval_s)
        servicer = ImageServicer(self.bus, self.process_manager, self.settings,
                                 self.annotations, engine=self.engine,
                                 api_endpoint=self.cfg.api.endpoint)
        server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=64),
            options=[("grpc.max_send_message_length", 64 << 20),
                     ("grpc.max_receive_message_length", 64 << 20)])
        pb_grpc.add_ImageServicer_to_server(servicer, server)
        server.add_generic_rpc_handlers((make_admin_handler(self.engine),))
        self.bound_grpc_port = server.add_insecure_port(f"0.0.0.0:{self._grpc_port}")
        server.start()
        self._grpc_server = server
        log.info("gRPC Image service on :%d (admin: /vep.Admin/*), REST on :%d",
                 self.bound_grpc_port, self._rest.bound_port)
        if self.engine is not None and self.engine.prof is not None:
            prof = self.engine.prof
            log.info("profiler ready: bundles under %s (trigger=%s, %d ms, min interval %gs)",
                     prof.directory, prof.trigger_enabled, prof.trigger_ms,
                     prof.trigger_min_interval_s)

    def wait(self) -> None:
        self._stopped.wait()

    def stop(self) -> None:
        log.info("shutting down")
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.router is not None:
            self.router.stop()
            self.router.detach()
        if self.fleet is not None:
            self.fleet.stop()
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=2).wait()
        if self._rest is not None:
            self._rest.stop()
        if self.engine is not None:
            self.engine.stop()
        if self._cascade_archiver is not None:
            self._cascade_archiver.stop()
        self.annotations.stop()
        self.cron.stop()
        # The registry stays: cameras resume on the next boot. Adoption
        # mode detaches: workers keep publishing through the restart.
        if self.cfg.worker_adoption:
            self.process_manager.detach()
        else:
            self.process_manager.close()
        self.bus.close()
        self.storage.close()
        self._stopped.set()


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description="video-edge-ai-proxy server (PyTorch port)")
    p.add_argument("--conf", default=None, help="path to conf.yaml")
    p.add_argument("--data_dir", default="/data/chrysalis")
    p.add_argument("--engine", action="store_true", help="run the inference engine")
    p.add_argument("--device", default="cuda", help="the engine's device (cuda or cpu)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    server = Server(load_config(args.conf), data_dir=args.data_dir, enable_engine=args.engine,
                    device=args.device)
    server.start()

    def _sig(_s, _f):
        threading.Thread(target=server.stop, daemon=True).start()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    server.wait()


if __name__ == "__main__":
    main()
