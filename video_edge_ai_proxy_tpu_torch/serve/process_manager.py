"""Camera lifecycle manager (counterpart of
``video_edge_ai_proxy_tpu/serve/process_manager.py``, its subprocess
runner).

A camera is an OS subprocess running ``python -m
video_edge_ai_proxy_tpu_torch.ingest.worker`` (the reference runs one
Docker container per camera) with the same lifecycle semantics:

- ``start``: spawn the worker with the reference's environment contract
  (``_contract_env``) under ``RLIMIT_AS`` (``WORKER_MEM_LIMIT_MB``) and
  ``nice`` (``WORKER_NICE``), seed the proxy keys on the bus when an RTMP
  endpoint is present, persist the registry record.
- restart policy "always": a supervisor thread respawns exited workers
  after a decorrelated-jitter backoff (``RESTART_BACKOFF_S`` growing
  toward ``RESTART_BACKOFF_MAX_S``), counting a failing streak that resets
  once a worker has run ``STABLE_AFTER_S``; a SIGKILL exit surfaces as
  ``oom_killed``.
- ``stop``: terminate, deregister, drop the bus ring and control keys.
- ``info`` / ``list`` / ``logs_since``: the persisted record with the live
  state, the worker's heartbeat and the last ``LOG_TAIL_LINES`` lines of
  its output.
- registry resume with re-adoption: on boot, a persisted camera whose
  worker is still alive (pid + the ``/proc`` birth tick + the worker
  module in its cmdline + its ``device_id``) and whose environment
  contract matches is re-attached, not respawned; a live worker of this
  camera whose contract differs is killed and respawned; anything else at
  that pid is left alone. Adoption needs ``log_dir`` (file-backed logs,
  no parent-death signal); with ``log_dir=""`` workers pipe to the server
  and die with it (resume = respawn).

The cmdline check names this package's worker module (``WORKER_MODULE``)
exactly, so neither package adopts the other's workers: a worker of the
JAX package at a registered pid is not ours, is left alone and a new one
is spawned. The container runner is not ported.
"""

from __future__ import annotations

import collections
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Optional

from ..bus import FrameBus
from ..bus.interface import KEY_KEYFRAME_ONLY_PREFIX, KEY_LAST_ACCESS_PREFIX
from ..ingest.worker import KEY_STATUS_PREFIX, parse_fresh_status
from ..resilience.policy import RetryPolicy
from ..utils.parsing import default_device_id
from .models import PREFIX_RTSP_PROCESS, ProcessState, RTMPStreamStatus, StreamProcess
from .storage import Storage

log = logging.getLogger("vep.torch.serve.process_manager")

# The worker every camera runs; _identify_worker matches it exactly.
WORKER_MODULE = "video_edge_ai_proxy_tpu_torch.ingest.worker"

LOG_TAIL_LINES = 100   # reference pulls last 100 container log lines (:296)
SUPERVISE_INTERVAL_S = 1.0
# Failing-streak restart backoff (resilience/policy.py): decorrelated
# jitter growing from RESTART_BACKOFF_S toward RESTART_BACKOFF_MAX_S, so
# a fleet of workers killed by one upstream outage does not restart in
# lockstep (the reference delegates this entirely to Docker
# restart-always, rtsp_process_manager.go:76, which has the same
# thundering-herd behavior).
RESTART_BACKOFF_S = 1.0
RESTART_BACKOFF_MAX_S = 10.0

# preexec_fn runs between fork and exec: nothing there may take locks, so the
# libc handle (and through it, prctl) must be resolved once at import time in
# the parent — a dlopen in the forked child can deadlock on an allocator or
# import lock held by another server thread at fork time.
if sys.platform == "linux":
    import ctypes

    _LIBC_PRCTL = ctypes.CDLL("libc.so.6", use_errno=True).prctl
else:  # pragma: no cover
    _LIBC_PRCTL = None

_PR_SET_PDEATHSIG = 1
_SIGTERM = 15


def _pdeathsig() -> None:
    """Child dies with the server (the reference gets this from dockerd
    owning the container lifecycle; a subprocess runner needs the kernel's
    parent-death signal)."""
    if _LIBC_PRCTL is not None:
        _LIBC_PRCTL(_PR_SET_PDEATHSIG, _SIGTERM)


# Per-worker resource limits — the reference caps each camera container
# (CPUShares 1024 equal weight, json-file logs 3x3 MB,
# ``rtsp_process_manager.go:71-78``). Subprocess equivalents: an address-
# space rlimit so one leaking worker cannot eat the host's decode budget,
# and a nice level so N busy decoders stay preemptible by the server/engine
# (niceness is the scheduler-weight analogue of equal CPUShares). The log
# cap is the in-memory tail ring (_Tail, LOG_TAIL_LINES).
WORKER_MEM_LIMIT_MB = 2048
WORKER_NICE = 5


# Imported at module load, NOT inside _worker_preexec: preexec_fn runs in
# the forked child of a multithreaded server, where the import machinery's
# locks may be held by a thread that no longer exists — touching it there
# can deadlock the child before exec.
try:
    import resource as _resource
except ImportError:  # non-POSIX; preexec is linux-gated at the call site
    _resource = None


def _worker_preexec(mem_limit_mb: int = WORKER_MEM_LIMIT_MB,
                    nice: int = WORKER_NICE,
                    pdeathsig: bool = True) -> None:
    """Runs between fork and exec (no locks, no imports, no allocation).
    ``pdeathsig=False`` when adoption is enabled: workers must survive a
    server restart to be re-adopted (the reference gets this from dockerd
    owning the container lifecycle)."""
    if pdeathsig:
        _pdeathsig()
    if mem_limit_mb > 0 and _resource is not None:
        lim = mem_limit_mb << 20
        _resource.setrlimit(_resource.RLIMIT_AS, (lim, lim))
    if nice:
        os.nice(nice)


def _proc_starttime(pid: int) -> Optional[int]:
    """The process's birth tick from ``/proc/<pid>/stat`` field 22 — a
    cookie that distinguishes "this exact process" from a reused pid."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as fh:
            stat = fh.read().decode("ascii", "replace")
    except OSError:
        return None
    # comm (field 2) may contain spaces/parens; fields resume after the
    # LAST ')'. starttime is field 22 overall = index 19 after comm+state.
    rest = stat.rsplit(")", 1)[-1].split()
    try:
        # rest[0] is state (field 3); field N maps to rest[N-3], so
        # starttime (field 22) is rest[19].
        return int(rest[19])
    except (IndexError, ValueError):
        return None


def _proc_state(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/stat", "rb") as fh:
            stat = fh.read().decode("ascii", "replace")
        return stat.rsplit(")", 1)[-1].split()[0]
    except OSError:
        return ""


# Sentinel exit code for adopted workers that died while not our child:
# the real status was reaped by init, so only "exited" is knowable. > 255
# so it can never collide with a genuine wait status or -signal.
ADOPTED_EXIT_UNKNOWN = 256


class _AdoptedProc:
    """Popen-shaped handle over a worker we did not spawn (re-adopted after
    a server restart). poll() prefers ``waitpid`` (exact status when the
    worker happens to be our child — same-process adoption) and falls back
    to /proc liveness gated on the birth-tick cookie."""

    def __init__(self, pid: int, starttime: Optional[int]):
        self.pid = pid
        self._starttime = starttime
        self._code: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self._code is not None:
            return self._code
        try:
            wpid, status = os.waitpid(self.pid, os.WNOHANG)
            if wpid == self.pid:
                self._code = (
                    -os.WTERMSIG(status) if os.WIFSIGNALED(status)
                    else os.WEXITSTATUS(status)
                )
                return self._code
        except ChildProcessError:
            pass  # not our child: /proc is the only source of truth
        except OSError:
            pass
        st = _proc_state(self.pid)
        alive = st not in ("", "Z", "X") and (
            self._starttime is None
            or _proc_starttime(self.pid) == self._starttime
        )
        if alive:
            return None
        self._code = ADOPTED_EXIT_UNKNOWN
        return self._code

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)

    def _signal(self, sig: int) -> None:
        if self.poll() is not None:
            return
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            pass

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = time.monotonic() + (timeout if timeout is not None else 3600)
        while time.monotonic() < deadline:
            code = self.poll()
            if code is not None:
                return code
            time.sleep(0.05)
        raise subprocess.TimeoutExpired(f"adopted:{self.pid}", timeout or 0)


class ProcessError(RuntimeError):
    pass


class _TailBase:
    """Bounded in-memory log ring with a monotone live-follow cursor
    (reference: Docker json-file logs capped at 3x3 MB,
    ``rtsp_process_manager.go:71-74``). Subclasses provide the pump."""

    def __init__(self, maxlen: int = 2000):
        self.lines: collections.deque[str] = collections.deque(maxlen=maxlen)
        self.total = 0  # lines ever pumped (monotone; live-follow cursor)
        self._lock = threading.Lock()

    def _append(self, line: str) -> None:
        with self._lock:
            self.lines.append(line.rstrip("\n"))
            self.total += 1

    def since(self, cursor: int) -> tuple[int, list[str]]:
        """(total, lines appended after ``cursor``). A cursor from before a
        worker restart (> total) or older than the ring resyncs to
        whatever the ring still holds."""
        with self._lock:
            total = self.total
            if cursor > total:
                cursor = total - len(self.lines)  # restarted: resend ring
            first_kept = total - len(self.lines)
            skip = max(0, cursor - first_kept)
            new = list(self.lines)[skip:]
        return total, new

    def snapshot(self, n: int) -> tuple[int, list[str]]:
        """(total, last n lines) — one consistent view; the pump thread
        mutates the deque, so iterating it unlocked can raise."""
        with self._lock:
            return self.total, list(self.lines)[-n:]

    def close(self) -> None:
        pass


class _Tail(_TailBase):
    """Tail over the worker's stdout PIPE (non-adoption mode); ends with
    the process, so close() is a no-op."""

    def __init__(self, proc: subprocess.Popen, maxlen: int = 2000):
        super().__init__(maxlen)
        self._thread = threading.Thread(
            target=self._pump, args=(proc,), daemon=True
        )
        self._thread.start()

    def _pump(self, proc: subprocess.Popen) -> None:
        assert proc.stdout is not None
        for line in proc.stdout:
            self._append(line)


# File-log cap: copytruncate when the log grows past this (the reference
# caps container logs at json-file 3 files x 3 MB,
# ``rtsp_process_manager.go:71-74``; one 9 MB budget, same bound).
LOG_MAX_BYTES = 9 << 20


class _FileTail(_TailBase):
    """Tail over a log FILE (adoption mode): the worker appends with its
    own fd, so the tail survives — and can be re-created after — a server
    restart. Preloads the ring from the existing file, then follows."""

    def __init__(self, path: str, maxlen: int = 2000):
        super().__init__(maxlen)
        self._path = path
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._follow, name="worker-logtail", daemon=True
        )
        self._thread.start()

    def _follow(self) -> None:
        fh = None
        try:
            while not self._closed.is_set():
                if fh is None:
                    try:
                        fh = open(self._path, "rb")  # binary: tell() is a
                        # byte offset, so partial-line rewind is exact
                    except OSError:
                        if self._closed.wait(0.2):
                            return
                        continue
                line = fh.readline()
                if line:
                    if line.endswith(b"\n"):
                        self._append(line.decode("utf-8", "replace"))
                    else:
                        # Partial write mid-line: wait for the rest.
                        fh.seek(fh.tell() - len(line))
                        self._closed.wait(0.05)
                    continue
                # EOF: rotate if oversized, detect truncation, then idle.
                try:
                    size = os.path.getsize(self._path)
                    if size > LOG_MAX_BYTES:
                        # copytruncate: O_APPEND writers land at offset 0
                        # after this; the ring already holds the recent
                        # lines, so nothing user-visible is lost.
                        with open(self._path, "r+b") as tf:
                            tf.truncate(0)
                        size = 0
                    if fh.tell() > size:
                        fh.close()
                        fh = None  # truncated under us: reopen from 0
                        continue
                except OSError:
                    pass
                if self._closed.wait(0.1):
                    return
        finally:
            if fh is not None:
                fh.close()

    def close(self) -> None:
        self._closed.set()


class _Entry:
    def __init__(self) -> None:
        self.proc: Optional[subprocess.Popen] = None
        self.tail: Optional[_Tail] = None
        self.failing_streak = 0
        self.restarting = False
        self.desired = True  # restart-policy always while desired
        self.last_exit = 0
        self.last_spawn = time.monotonic()
        self.inference_model = ""  # per-stream engine model override
        self.annotation_policy = ""  # per-stream annotation emit override
        self.restart_due = 0.0  # backoff deadline; 0 = not pending
        self.backoff_s = 0.0  # previous backoff (decorrelated-jitter seed)


class ProcessManager:
    def __init__(
        self,
        storage: Storage,
        bus: FrameBus,
        shm_dir: str = "/dev/shm/vep_tpu",
        disk_buffer_path: str = "",
        python: str = sys.executable,
        bus_backend: str = "shm",
        redis_addr: str = "127.0.0.1:6379",
        redis_password: str = "",
        redis_db: int = 0,
        mem_limit_mb: int = WORKER_MEM_LIMIT_MB,
        nice: int = WORKER_NICE,
        log_dir: str = "",
    ):
        self._storage = storage
        self._bus = bus
        self._shm_dir = shm_dir
        # Adoption mode: workers log to files under log_dir and skip the
        # parent-death signal, so they outlive the server and resume() can
        # re-attach to them ("" = pipe logs, workers die with the server).
        self._log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        self._adopt = bool(log_dir)
        self._bus_backend = bus_backend
        self._redis_addr = redis_addr
        self._redis_password = redis_password
        self._redis_db = redis_db
        self._disk_buffer_path = disk_buffer_path
        self._python = python
        self._mem_limit_mb = mem_limit_mb
        self._nice = nice
        self._entries: dict[str, _Entry] = {}
        self._stopping: set[str] = set()  # mid-stop ids (see stop())
        # Supervisor restart pacing: next_delay() only — the supervisor
        # loop owns the clock (backoff is a deadline, not a sleep).
        self._restart_policy = RetryPolicy(
            base_s=RESTART_BACKOFF_S, cap_s=RESTART_BACKOFF_MAX_S
        )
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._supervisor = threading.Thread(
            target=self._supervise, name="process-supervisor", daemon=True
        )
        self._supervisor.start()

    # -- lifecycle --

    def start(self, record: StreamProcess) -> StreamProcess:
        if not record.rtsp_endpoint:
            raise ProcessError("rtsp_endpoint required")
        device_id = record.name or default_device_id(record.rtsp_endpoint)
        record.name = device_id
        with self._lock:
            if device_id in self._entries:
                raise ProcessError(f"process {device_id!r} already exists")
            entry = _Entry()
            entry.inference_model = record.inference_model
            entry.annotation_policy = record.annotation_policy
            self._entries[device_id] = entry
        now = StreamProcess.now_ms()
        record.created = record.created or now
        record.modified = now
        record.status = "running"
        record.rtmp_stream_status = record.rtmp_stream_status or RTMPStreamStatus(
            streaming=True, storing=False
        )
        if record.rtmp_endpoint:
            # Seed proxy keys so the worker sees consistent toggle state from
            # packet one (reference rtsp_process_manager.go:121-135).
            self._bus.set_proxy_rtmp(device_id, True)
            self._bus.touch_query(device_id)
        try:
            self._spawn(record, entry)
        except Exception:
            with self._lock:
                self._entries.pop(device_id, None)
            raise
        self._persist(record)
        log.info("started camera process %s (%s)", device_id, record.rtsp_endpoint)
        return record

    def _contract_env(self, record: StreamProcess) -> dict:
        """The worker's env contract (reference
        rtsp_process_manager.go:96-104 + this framework's bus wiring) —
        shared by the spawn and the adoption contract check."""
        return dict(
            rtsp_endpoint=record.rtsp_endpoint,
            device_id=record.name,
            rtmp_endpoint=record.rtmp_endpoint or "",
            in_memory_buffer="1",
            disk_buffer_path=self._disk_buffer_path,
            vep_shm_dir=self._shm_dir,
            # Workers are separate processes: an in-proc "memory" bus can't
            # cross the boundary, so they get the shm fast path instead.
            vep_bus_backend=(
                "shm" if self._bus_backend == "memory" else self._bus_backend
            ),
            vep_redis_addr=self._redis_addr,
            vep_redis_password=self._redis_password,
            vep_redis_db=str(self._redis_db),
            PYTHONUNBUFFERED="1",
        )

    def _spawn(self, record: StreamProcess, entry: _Entry) -> None:
        env = dict(os.environ)
        # Ensure the worker can import this package regardless of cwd.
        pkg_parent = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = (
            pkg_parent + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH")
            else pkg_parent
        )
        env.update(self._contract_env(record))
        if entry.tail is not None:
            entry.tail.close()  # replacing a previous run's follower
        argv = [self._python, "-m", WORKER_MODULE]
        if self._log_dir:
            # Adoption mode: file-backed logs (the worker owns its fd, so
            # logging survives server death — a broken stdout pipe would
            # otherwise SIGPIPE the orphan) and no pdeathsig.
            log_path = os.path.join(self._log_dir, f"{record.name}.log")
            with open(log_path, "ab") as log_fh:
                proc = subprocess.Popen(
                    argv, env=env,
                    stdout=log_fh, stderr=subprocess.STDOUT,
                    preexec_fn=(
                        (lambda: _worker_preexec(
                            self._mem_limit_mb, self._nice, pdeathsig=False))
                        if sys.platform == "linux" else None
                    ),
                )
            entry.tail = _FileTail(log_path)
            record.runtime = {
                "pid": proc.pid,
                "starttime": _proc_starttime(proc.pid),
                "log_path": log_path,
            }
        else:
            proc = subprocess.Popen(
                argv, env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                preexec_fn=(
                    (lambda: _worker_preexec(self._mem_limit_mb, self._nice))
                    if sys.platform == "linux" else None
                ),
            )
            entry.tail = _Tail(proc)
            record.runtime = None
        entry.proc = proc
        entry.last_spawn = time.monotonic()
        record.container_id = f"{proc.pid}@{os.uname().nodename}"

    def inference_model_of(self, device_id: str) -> str:
        """Per-stream engine model override (StreamProcess.inference_model);
        "" means the engine default. Lock-free dict read — called by the
        engine collector every tick."""
        entry = self._entries.get(device_id)
        return entry.inference_model if entry is not None else ""

    def annotation_policy_of(self, device_id: str) -> str:
        """Per-stream annotation emit policy override
        (StreamProcess.annotation_policy); "" means the engine default.
        Lock-free dict read — called by the engine per emitted frame."""
        entry = self._entries.get(device_id)
        return entry.annotation_policy if entry is not None else ""

    def stop(self, device_id: str) -> None:
        with self._lock:
            entry = self._entries.pop(device_id, None)
            # Marked before the (up to ~15 s) terminate/wait below: list()
            # still sees the storage record during that window, and a
            # deliberate stop must read as "exited", not as a dead worker
            # nobody supervises — /healthz gates readiness on the latter.
            self._stopping.add(device_id)
        try:
            if entry is None:
                # Still clean the registry if a stale record exists
                # (reference Stop deletes datastore entry even when the container
                # is already gone, rtsp_process_manager.go:153-188).
                if self._storage.get_or_none(PREFIX_RTSP_PROCESS, device_id) is None:
                    raise ProcessError(f"process {device_id!r} not found")
            else:
                entry.desired = False
                if entry.proc and entry.proc.poll() is None:
                    entry.proc.terminate()
                    try:
                        entry.proc.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        entry.proc.kill()
                        entry.proc.wait(timeout=5)
                if entry.tail is not None:
                    entry.tail.close()
            if self._log_dir:
                # Deregistered camera leaves no log behind (reference Stop
                # deletes the container and with it its json-file logs).
                try:
                    os.unlink(os.path.join(self._log_dir, f"{device_id}.log"))
                except OSError:
                    pass
            self._storage.delete(PREFIX_RTSP_PROCESS, device_id)
            self._bus.drop_stream(device_id)
            self._bus.kv_del(KEY_STATUS_PREFIX + device_id)
            self._bus.hdel_all(KEY_LAST_ACCESS_PREFIX + device_id)
            self._bus.kv_del(KEY_KEYFRAME_ONLY_PREFIX + device_id)
        finally:
            with self._lock:
                self._stopping.discard(device_id)
        log.info("stopped camera process %s", device_id)

    def stop_all(self) -> None:
        for device_id in self.device_ids():
            try:
                self.stop(device_id)
            except ProcessError:
                pass

    # -- queries --

    def device_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def info(self, device_id: str) -> StreamProcess:
        raw = self._storage.get_or_none(PREFIX_RTSP_PROCESS, device_id)
        if raw is None:
            raise ProcessError(f"process {device_id!r} not found")
        record = StreamProcess.from_json(raw)
        with self._lock:
            entry = self._entries.get(device_id)
            stopping = device_id in self._stopping
        record.state = self._live_state(entry)
        if entry is None and stopping:
            # Mid-stop: supervision was detached on purpose; not the
            # nobody-will-ever-restart-this outage `dead` means.
            record.state.dead = False
            record.state.status = "exited"
        record.status = record.state.status
        record.limits = {
            "mem_limit_mb": self._mem_limit_mb,
            "nice": self._nice,
            "log_tail_lines": LOG_TAIL_LINES,
        }
        # Live heartbeat extras: which media path the worker is actually
        # on (packet vs the degraded opencv fallback vs synthetic) —
        # stale heartbeats report nothing (shared freshness bar,
        # ingest/worker.py::parse_fresh_status).
        hb = parse_fresh_status(
            self._bus.kv_get(KEY_STATUS_PREFIX + device_id),
            int(time.time() * 1000),
        )
        record.source = hb.get("source", "")
        record.heartbeat = hb
        if entry and entry.tail:
            total, lines = entry.tail.snapshot(LOG_TAIL_LINES)
            record.logs = {
                "stdout": lines,
                # Live-follow cursor: pass back as ?since= on the logs
                # endpoint to receive only lines appended after this tail.
                "total": total,
            }
        return record

    def logs_since(self, device_id: str, cursor: int) -> dict:
        """Incremental log tail for live following (the reference streams
        container stdout into the portal's xterm view,
        ``process-details.component.ts:58-73``; a subprocess runner serves
        the same need with an offset cursor over the tail ring)."""
        with self._lock:
            entry = self._entries.get(device_id)
        if entry is None or entry.tail is None:
            if self._storage.get_or_none(PREFIX_RTSP_PROCESS, device_id) is None:
                raise ProcessError(f"process {device_id!r} not found")
            return {"total": 0, "lines": []}
        total, lines = entry.tail.since(cursor)
        return {"total": total, "lines": lines}

    def list(self) -> list[StreamProcess]:
        out = []
        for device_id in sorted(self._storage.list(PREFIX_RTSP_PROCESS)):
            try:
                out.append(self.info(device_id))
            except ProcessError:
                continue
        return out

    def update_record(self, record: StreamProcess) -> None:
        """Reference ``UpdateProcessInfo`` (rtsp_process_manager.go:338-356)."""
        record.modified = StreamProcess.now_ms()
        self._persist(record)

    def _live_state(self, entry: Optional[_Entry]) -> ProcessState:
        if entry is None or entry.proc is None:
            return ProcessState(status="exited", running=False, dead=True)
        code = entry.proc.poll()
        if code is None:
            return ProcessState(
                status="restarting" if entry.restarting else "running",
                running=True,
                pid=entry.proc.pid,
                restarting=entry.restarting,
                failing_streak=entry.failing_streak,
                # Sticky across the restart (the reference surfaces Docker's
                # OOMKilled the same way): the PREVIOUS run's SIGKILL exit
                # stays visible so ListStreams health shows why the streak
                # is climbing, not just that it is.
                oom_killed=entry.last_exit == -signal.SIGKILL,
            )
        return ProcessState(
            status="restarting" if entry.desired else "exited",
            running=False,
            pid=entry.proc.pid,
            exit_code=code,
            restarting=entry.desired,
            failing_streak=entry.failing_streak,
            # SIGKILL exit is the kernel OOM killer's signature for a
            # subprocess runner (the reference reads Docker's OOMKilled flag,
            # ``grpc_api.go:102-117``; without a cgroup supervisor, -9 is
            # the best-available heuristic and can also mean a manual
            # kill -9 — surfaced identically in ListStreams either way).
            oom_killed=code == -signal.SIGKILL,
        )

    # -- persistence / resume --

    def _persist(self, record: StreamProcess) -> None:
        # state/logs are runtime-only views attached by info(); persisting
        # them would rewrite the log tail into the registry on every toggle
        # and resurrect a previous boot's state as if current.
        clean = StreamProcess.from_json(record.to_json())
        clean.state = None
        clean.logs = None
        self._storage.put(PREFIX_RTSP_PROCESS, clean.name, clean.to_json())

    def resume(self) -> int:
        """Boot-time registry resume (reference
        rtsp_process_manager.go:191-233): re-ADOPT each persisted camera
        whose worker is still alive and matches the record's env contract
        (frames never stop flowing across a control-plane restart); kill +
        respawn a live worker whose contract no longer matches; respawn
        when the worker is gone or the pid now belongs to someone else."""
        count = 0
        for device_id, raw in self._storage.list(PREFIX_RTSP_PROCESS).items():
            with self._lock:
                if device_id in self._entries:
                    continue
                entry = _Entry()
                self._entries[device_id] = entry
            record = StreamProcess.from_json(raw)
            entry.inference_model = record.inference_model
            entry.annotation_policy = record.annotation_policy
            try:
                if self._try_adopt(device_id, record, entry):
                    self._persist(record)
                    count += 1
                    continue
                self._spawn(record, entry)
                self._persist(record)
                count += 1
            except Exception as exc:
                log.error("failed to resume %s: %s", device_id, exc)
                with self._lock:
                    self._entries.pop(device_id, None)
        return count

    def _identify_worker(self, pid: int, starttime,
                         device_id: str) -> Optional[dict]:
        """The environ of the process at ``pid`` IF it is provably this
        camera's surviving worker: birth-tick cookie matches (no pid
        reuse), cmdline is our worker module, env device_id is this
        camera. None otherwise — a pid that now belongs to anything else
        must never be touched."""
        if _proc_state(pid) in ("", "Z", "X"):
            return None
        if starttime is not None and _proc_starttime(pid) != starttime:
            return None
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmdline = fh.read().split(b"\0")
            with open(f"/proc/{pid}/environ", "rb") as fh:
                environ = dict(
                    pair.split(b"=", 1)
                    for pair in fh.read().split(b"\0") if b"=" in pair
                )
        except OSError:
            return None
        if WORKER_MODULE.encode() not in cmdline:
            return None
        if environ.get(b"device_id", b"").decode() != device_id:
            return None
        return environ

    def _try_adopt(self, device_id: str, record: StreamProcess,
                   entry: _Entry) -> bool:
        """Attach to a still-running worker from a previous server life.
        True only when the persisted pid is provably the SAME process
        (birth-tick cookie + cmdline + device_id) and its FULL env
        contract — media endpoints AND bus/buffer wiring — matches what
        _spawn would set today. Any verified-ours-but-stale worker (env
        drift, or adoption now disabled) is killed first so the respawn is
        the only publisher on the ring; an unverifiable pid is left alone."""
        rt = record.runtime
        if not rt or not rt.get("pid"):
            return False
        pid = int(rt["pid"])
        environ = self._identify_worker(pid, rt.get("starttime"), device_id)
        if environ is None:
            return False
        # The full contract _spawn would set NOW (reference env contract +
        # bus/buffer wiring): a worker frozen on an old shm_dir or Redis
        # would be adopted "live" yet publish where the new server never
        # looks — every checked key must match current config.
        want = self._contract_env(record)
        same_contract = self._adopt and self._log_dir and all(
            environ.get(k.encode(), b"").decode() == v
            for k, v in want.items()
        )
        proc = _AdoptedProc(pid, rt.get("starttime"))
        if not same_contract:
            # Our worker, wrong config (record/config changed while we were
            # down, or adoption was turned off): kill it — leaving it would
            # put two publishers on one ring once we respawn.
            log.warning(
                "worker %s (pid %d) env contract stale; killing for respawn",
                device_id, pid,
            )
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
            return False
        entry.proc = proc
        entry.last_spawn = time.monotonic()
        entry.tail = _FileTail(
            rt.get("log_path")
            or os.path.join(self._log_dir, f"{device_id}.log"),
        )
        log.info("re-adopted live worker %s (pid %d)", device_id, pid)
        return True

    # -- supervision (RestartPolicy: always) --

    # A worker alive this long after (re)spawn is considered stable and its
    # failing streak resets (Docker's restart policy resets the streak once
    # the container runs successfully).
    STABLE_AFTER_S = 30.0

    def _supervise(self) -> None:
        while not self._stop.wait(SUPERVISE_INTERVAL_S):
            self._supervise_once(time.monotonic())

    def _supervise_once(self, now: float) -> None:
        """One supervision pass at monotonic time ``now``: count exits,
        schedule and run due restarts, reset the streak of workers that
        ran STABLE_AFTER_S."""
        with self._lock:
            snapshot = list(self._entries.items())
        for device_id, entry in snapshot:
            proc = entry.proc
            if proc is None or not entry.desired:
                continue
            try:
                code = proc.poll()
            except Exception:
                # An unexpected failure must not kill the supervisor
                # thread for every camera. Treat as "state unknown,
                # assume alive" until the next cycle answers.
                log.exception("supervisor poll for %s failed", device_id)
                continue
            if code is None:
                if (
                    entry.failing_streak
                    and not entry.restarting
                    and now - entry.last_spawn > self.STABLE_AFTER_S
                ):
                    entry.failing_streak = 0
                    entry.backoff_s = 0.0  # healthy interval: backoff
                    # restarts from base on the next failure
                    # Stable again: clear the last-exit cause so
                    # oom_killed stops reporting a long-gone event
                    # (Docker clears OOMKilled on a healthy restart too).
                    entry.last_exit = 0
                continue
            if not entry.restarting:
                entry.failing_streak += 1
                entry.restarting = True
                entry.last_exit = code
                # Backoff as a deadline, not a sleep: one flapping camera
                # must not delay supervision of the others. Decorrelated
                # jitter (RetryPolicy.next_delay) de-synchronizes a
                # fleet's restarts after a shared-cause kill.
                entry.backoff_s = self._restart_policy.next_delay(
                    entry.backoff_s or None
                )
                entry.restart_due = now + entry.backoff_s
                log.warning(
                    "worker %s exited code=%s streak=%d; restart in %.1fs",
                    device_id, code, entry.failing_streak,
                    entry.restart_due - now,
                )
            if now < entry.restart_due:
                continue
            raw = self._storage.get_or_none(PREFIX_RTSP_PROCESS, device_id)
            if raw is None:
                entry.restarting = False
                continue  # stopped concurrently
            record = StreamProcess.from_json(raw)
            try:
                self._spawn(record, entry)
                self._persist(record)
            except Exception as exc:
                log.error("restart of %s failed: %s", device_id, exc)
            entry.restarting = False

    def close(self) -> None:
        self._stop.set()
        self._supervisor.join(timeout=15)
        self.shutdown_workers()

    def detach(self) -> None:
        """Stop supervising WITHOUT killing workers: the adoption-mode
        shutdown (reference parity — its server shutdown leaves camera
        containers running under dockerd; the next boot re-attaches,
        rtsp_process_manager.go:191-233). Workers keep demuxing/publishing;
        resume() on the next boot adopts them via the persisted runtime
        descriptor."""
        self._stop.set()
        self._supervisor.join(timeout=15)
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for entry in entries:
            if entry.tail is not None:
                entry.tail.close()

    def shutdown_workers(self) -> None:
        """Terminate workers without deregistering (server shutdown keeps the
        registry so ``resume()`` restores cameras on next boot)."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for entry in entries:
            entry.desired = False
            if entry.proc and entry.proc.poll() is None:
                entry.proc.terminate()
        for entry in entries:
            if entry.proc and entry.proc.poll() is None:
                try:
                    entry.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    entry.proc.kill()
            if entry.tail is not None:
                entry.tail.close()
