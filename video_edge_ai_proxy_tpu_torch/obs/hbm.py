"""Device-memory attribution (counterpart of
``video_edge_ai_proxy_tpu/obs/hbm.py``): per-program footprints, live
per-pool byte ledgers, and a time-to-OOM forecast against the budget.

``HbmTracker`` (engine-owned, ``EngineConfig.hbm``):

- **Program footprints.** One per (model, stem, geometry, bucket, mesh)
  program, noted when its CUDA graph is captured: the static input bytes
  (``argument_bytes``), the static output bytes (``output_bytes``) and
  the growth of the graph pool's reserved bytes during that capture
  (``temp_bytes``: the step's intermediates, the int8 path's im2col
  buffers among them, and its outputs; the pool is shared, so a later key
  that fits in what earlier keys reserved grows it by 0). No code bytes,
  no donation. Programs run one at a time, so the model is the sum of
  code bytes plus the largest single workspace.
- **Pools.** ``register_pool(name, nbytes_fn)``: each pool the engine owns
  (``thumbs``, ``track_state``, ``prefetch``, ``collector_host``) reports
  its current bytes from its own tensors' ``nbytes``, so the tracked bytes
  equal the pools' own by construction.
- **Budget and forecast.** The card's total memory
  (``torch.cuda.mem_get_info``, installed at warmup by ``set_budget``) or
  a synthetic budget on the CPU; ``evaluate`` (tick thread, throttled)
  samples the used bytes, smooths the utilization slope and extrapolates
  ``time_to_oom_s``; burn rates over window peaks. ``pressure()`` feeds the
  degradation ladder.

Families (gauges unless noted): ``vep_hbm_budget_bytes``,
``vep_hbm_used_bytes``, ``vep_hbm_pool_bytes{pool}``,
``vep_hbm_program_code_bytes``, ``vep_hbm_program_workspace_bytes``,
``vep_hbm_donated_saved_bytes``, ``vep_hbm_programs_total`` (counter),
``vep_hbm_utilization{window}``, ``vep_hbm_burn_rate{window}``,
``vep_hbm_headroom_bytes``, ``vep_hbm_time_to_oom_seconds`` (-1 = not
trending toward OOM). The pool callables read metadata only: no copy, no
synchronisation.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, Optional, Tuple, Union

from . import metrics

# The budget on the CPU, where there is no card to ask and the config
# pins none: big enough that the tiny models never read as pressured,
# small enough that a runaway pool still trips the forecast.
DEFAULT_SYNTHETIC_BUDGET_BYTES = 4 << 30

PoolBytes = Union[int, Dict[str, int]]


class _PeakRing:
    """Per-bin high-water marks over the slow window: memory is a level,
    not a rate, so the window's peak is what OOM cares about. O(1)
    record, O(n_bins) peak scan at evaluate time."""

    __slots__ = ("_bin_s", "_n", "_peak", "_epochs")

    def __init__(self, span_s: float, bin_s: float):
        self._bin_s = float(bin_s)
        self._n = max(int(math.ceil(span_s / bin_s)) + 1, 2)
        self._peak = [0.0] * self._n
        self._epochs = [-1] * self._n

    def record(self, value: float, now: float) -> None:
        epoch = int(now // self._bin_s)
        i = epoch % self._n
        if self._epochs[i] != epoch:
            self._epochs[i] = epoch
            self._peak[i] = 0.0
        if value > self._peak[i]:
            self._peak[i] = value

    def peak(self, window_s: float, now: float) -> float:
        """Max recorded value across bins younger than ``window_s``."""
        lo_epoch = int((now - window_s) // self._bin_s)
        now_epoch = int(now // self._bin_s)
        peak = 0.0
        for i in range(self._n):
            e = self._epochs[i]
            if lo_epoch < e <= now_epoch and self._peak[i] > peak:
                peak = self._peak[i]
        return peak


class _Program:
    """One program's memory footprint (bytes; see the module docstring)."""

    __slots__ = ("argument", "output", "temp", "code", "alias", "count")

    def __init__(self, summary: Dict[str, int]):
        self.argument = int(summary.get("argument_bytes", 0))
        self.output = int(summary.get("output_bytes", 0))
        self.temp = int(summary.get("temp_bytes", 0))
        self.code = int(summary.get("code_bytes", 0))
        self.alias = int(summary.get("alias_bytes", 0))
        self.count = 1      # recompiles of the same key overwrite

    @property
    def workspace(self) -> int:
        """Live bytes while this program executes: arguments + outputs +
        temp, minus donated-argument aliasing (0 in the port)."""
        return max(0, self.argument + self.output + self.temp - self.alias)


class HbmTracker:
    """Engine-owned device-memory plane: program footprints, pool ledger,
    budget forecast.

    ``note_program`` runs once per captured program; ``register_pool``
    arms the ledger; ``evaluate`` is the forecast step (tick thread,
    throttled to ``eval_interval_s``); ``snapshot`` is the read surface.
    The clock is injectable."""

    def __init__(self, *, budget_bytes: int = 0,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 1800.0,
                 bin_s: float = 1.0,
                 util_objective: float = 0.9,
                 slope_alpha: float = 0.3,
                 eval_interval_s: float = 1.0,
                 pressure_horizon_s: float = 120.0,
                 clock=time.monotonic,
                 registry: Optional[metrics.Registry] = None):
        if not 0.0 < util_objective <= 1.0:
            raise ValueError(
                f"util_objective must be in (0, 1], got {util_objective}")
        if fast_window_s >= slow_window_s:
            raise ValueError(
                f"fast window ({fast_window_s}s) must be shorter than the "
                f"slow window ({slow_window_s}s)")
        if budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes}")
        self.budget_bytes = (int(budget_bytes) if budget_bytes
                             else DEFAULT_SYNTHETIC_BUDGET_BYTES)
        #: True once set_budget() installed a device-reported budget
        #: (the snapshot distinguishes measured from synthetic).
        self.budget_measured = False
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.bin_s = float(bin_s)
        self.util_objective = float(util_objective)
        self.slope_alpha = float(slope_alpha)
        self.eval_interval_s = float(eval_interval_s)
        self.pressure_horizon_s = float(pressure_horizon_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._programs: Dict[Tuple[str, str, str, int, str], _Program] = {}
        self._pools: Dict[str, Callable[[], PoolBytes]] = {}
        self._ring = _PeakRing(slow_window_s, bin_s)
        # Forecast state (updated only in evaluate()).
        self._next_eval = 0.0
        self._prev_util: Optional[float] = None
        self._prev_eval_t: Optional[float] = None
        self._slope_ema: Optional[float] = None   # utilization / second
        self._last: dict = {
            "used_bytes": 0,
            "utilization": {"fast": 0.0, "slow": 0.0},
            "burn": {"fast": 0.0, "slow": 0.0},
            "burning": False,
            "headroom_bytes": self.budget_bytes,
            "slope_per_s": None,
            "time_to_oom_s": None,
            "pressure": False,
        }
        reg = registry if registry is not None else metrics.registry
        self._m_budget = reg.gauge(
            "vep_hbm_budget_bytes",
            "Device memory budget (the card's total memory, or the "
            "configured or synthetic budget)").labels()
        self._m_used = reg.gauge(
            "vep_hbm_used_bytes",
            "Modeled resident bytes: pools + program code + peak single-"
            "program workspace").labels()
        self._m_pool = reg.gauge(
            "vep_hbm_pool_bytes",
            "Live bytes per registered device/host pool", ("pool",))
        self._m_code = reg.gauge(
            "vep_hbm_program_code_bytes",
            "Generated-code bytes summed over resident programs (0: CUDA "
            "graphs hold none of their own)"
        ).labels()
        self._m_workspace = reg.gauge(
            "vep_hbm_program_workspace_bytes",
            "Largest single-program workspace (static inputs + outputs + "
            "graph pool growth at capture)").labels()
        self._m_saved = reg.gauge(
            "vep_hbm_donated_saved_bytes",
            "Bytes saved by donated-argument aliasing across resident "
            "programs (0: the port donates none)").labels()
        self._m_programs = reg.counter(
            "vep_hbm_programs_total",
            "Programs footprinted at their capture"
        ).labels()
        self._m_util = reg.gauge(
            "vep_hbm_utilization",
            "Window-peak used bytes over the budget", ("window",))
        self._m_burn = reg.gauge(
            "vep_hbm_burn_rate",
            "HBM burn multiple per window (utilization over the "
            "sustainable objective)", ("window",))
        self._m_headroom = reg.gauge(
            "vep_hbm_headroom_bytes",
            "Budget minus modeled used bytes").labels()
        self._m_tto = reg.gauge(
            "vep_hbm_time_to_oom_seconds",
            "EWMA-slope OOM forecast (-1 = not trending toward OOM)"
        ).labels()
        self._m_budget.set(self.budget_bytes)
        self._m_headroom.set(self.budget_bytes)
        self._m_tto.set(-1.0)

    # -- budget ----------------------------------------------------------

    def set_budget(self, budget_bytes: int, *, measured: bool = True) -> None:
        """Install the device's budget (the engine's warmup calls this
        with the card's total memory; the CPU keeps the configured or
        synthetic budget)."""
        if budget_bytes <= 0:
            return
        with self._lock:
            self.budget_bytes = int(budget_bytes)
            self.budget_measured = bool(measured)
        self._m_budget.set(self.budget_bytes)

    # -- program footprints (once per captured program) -----------------

    def note_program(self, model: str, src_hw: Tuple[int, int], bucket: int,
                     summary: Dict[str, int], *, stem: str = "classic",
                     mesh: str = "") -> None:
        """Record one program's footprint summary (``argument_bytes``,
        ``output_bytes``, ``temp_bytes``, ``code_bytes``, ``alias_bytes``)
        under its ``(model, stem, geometry, bucket, mesh)`` key. A rebuild
        of the same key overwrites: the model is the resident programs."""
        if not summary:
            return
        geometry = f"{src_hw[0]}x{src_hw[1]}"
        key = (str(model), str(stem), geometry, int(bucket), str(mesh))
        with self._lock:
            prev = self._programs.get(key)
            prog = _Program(summary)
            if prev is not None:
                prog.count = prev.count + 1
            self._programs[key] = prog
            code = sum(p.code for p in self._programs.values())
            workspace = max(
                (p.workspace for p in self._programs.values()), default=0)
            saved = sum(p.alias for p in self._programs.values())
        self._m_programs.inc()
        self._m_code.set(code)
        self._m_workspace.set(workspace)
        self._m_saved.set(saved)

    # -- dynamic pool ledger ---------------------------------------------

    def register_pool(self, name: str,
                      nbytes_fn: Callable[[], PoolBytes]) -> None:
        """Arm live byte accounting for one pool. ``nbytes_fn()`` returns
        the pool's current bytes (an int, or ``{shard: int}``), read at
        evaluate and snapshot time only. Registering an existing name
        replaces the callable."""
        with self._lock:
            self._pools[str(name)] = nbytes_fn

    def pools(self) -> dict:
        """Live per-pool bytes: ``{"total": int, "pools": {name:
        {"bytes": int, "shards": {shard: int} | None}}}``. A pool whose
        callable raises reads as 0 bytes with ``"error"`` set: the
        forecast degrades, the tick loop goes on."""
        with self._lock:
            fns = list(self._pools.items())
        out: Dict[str, dict] = {}
        total = 0
        for name, fn in fns:
            row: dict = {"bytes": 0, "shards": None}
            try:
                val = fn()
            except Exception as exc:  # noqa: BLE001 (the tick loop goes on)
                row["error"] = f"{type(exc).__name__}: {exc}"
                out[name] = row
                continue
            if isinstance(val, dict):
                shards = {str(k): int(v) for k, v in val.items()}
                row["shards"] = shards
                row["bytes"] = sum(shards.values())
            else:
                row["bytes"] = int(val)
            total += row["bytes"]
            out[name] = row
        return {"total": total, "pools": out}

    # -- forecast (tick thread, throttled) -------------------------------

    def _used(self) -> Tuple[int, dict, int, int, int]:
        """(used, pools, code, workspace, saved) — the budget model."""
        pools = self.pools()
        with self._lock:
            code = sum(p.code for p in self._programs.values())
            workspace = max(
                (p.workspace for p in self._programs.values()), default=0)
            saved = sum(p.alias for p in self._programs.values())
        used = pools["total"] + code + workspace
        return used, pools, code, workspace, saved

    def evaluate(self, now: Optional[float] = None,
                 force: bool = False) -> dict:
        """Sample used bytes, update the forecast + burn state; throttled
        to ``eval_interval_s`` unless forced. Returns the live state dict
        (also retained for snapshot())."""
        now = self._clock() if now is None else now
        if not force and now < self._next_eval:
            return self._last
        self._next_eval = now + self.eval_interval_s
        used, pools, code, workspace, saved = self._used()
        budget = self.budget_bytes
        self._ring.record(float(used), now)
        u_now = used / budget if budget else 0.0
        u_fast = self._ring.peak(self.fast_window_s, now) / budget \
            if budget else 0.0
        u_slow = self._ring.peak(self.slow_window_s, now) / budget \
            if budget else 0.0
        # EWMA utilization slope (per second) on the instant level: ramps
        # register within an eval interval, the EMA keeps one allocation
        # burst from whipsawing the OOM estimate.
        if self._prev_util is not None and self._prev_eval_t is not None \
                and now > self._prev_eval_t:
            slope = (u_now - self._prev_util) / (now - self._prev_eval_t)
            self._slope_ema = (
                slope if self._slope_ema is None
                else self.slope_alpha * slope
                + (1.0 - self.slope_alpha) * self._slope_ema)
        self._prev_util = u_now
        self._prev_eval_t = now
        headroom_frac = max(0.0, 1.0 - u_now)
        headroom_bytes = max(0, budget - used)
        tto: Optional[float] = None
        if self._slope_ema is not None and self._slope_ema > 1e-9:
            tto = headroom_frac / self._slope_ema
        burn_fast = u_fast / self.util_objective
        burn_slow = u_slow / self.util_objective
        burning = burn_fast > 1.0 and burn_slow > 1.0
        pressure = burning or (
            tto is not None and tto <= self.pressure_horizon_s)
        self._last = {
            "used_bytes": used,
            "utilization": {"fast": u_fast, "slow": u_slow},
            "burn": {"fast": burn_fast, "slow": burn_slow},
            "burning": burning,
            "headroom_bytes": headroom_bytes,
            "slope_per_s": self._slope_ema,
            "time_to_oom_s": tto,
            "pressure": pressure,
        }
        self._m_used.set(used)
        self._m_code.set(code)
        self._m_workspace.set(workspace)
        self._m_saved.set(saved)
        self._m_util.labels("fast").set(u_fast)
        self._m_util.labels("slow").set(u_slow)
        self._m_burn.labels("fast").set(burn_fast)
        self._m_burn.labels("slow").set(burn_slow)
        self._m_headroom.set(headroom_bytes)
        self._m_tto.set(tto if tto is not None else -1.0)
        for name, row in pools["pools"].items():
            self._m_pool.labels(name).set(row["bytes"])
        return self._last

    def pressure(self) -> bool:
        """The degradation ladder's verdict from the last evaluate: burning
        on both windows, or forecast to OOM inside ``pressure_horizon_s``.
        One dict read."""
        return bool(self._last["pressure"])

    # -- read surfaces ----------------------------------------------------

    def programs(self) -> Dict[str, dict]:
        """Per-program footprint rows (copies), keyed
        ``model|stem|geometry|bucket|mesh``."""
        with self._lock:
            return {
                "|".join((model, stem, geometry, str(bucket), mesh or "-")): {
                    "argument_bytes": p.argument,
                    "output_bytes": p.output,
                    "temp_bytes": p.temp,
                    "code_bytes": p.code,
                    "alias_bytes": p.alias,
                    "workspace_bytes": p.workspace,
                    "compiles": p.count,
                }
                for (model, stem, geometry, bucket, mesh), p
                in self._programs.items()
            }

    def snapshot(self) -> dict:
        """JSON-able state for /api/v1/hbm and /api/v1/stats. Runs a
        (throttled) evaluate, so a reader sees a live forecast."""
        state = self.evaluate()
        used, pools, code, workspace, saved = self._used()
        return {
            "budget_bytes": self.budget_bytes,
            "budget_measured": self.budget_measured,
            "util_objective": self.util_objective,
            "windows_s": {"fast": self.fast_window_s,
                          "slow": self.slow_window_s},
            "used_bytes": used,
            "utilization": {k: round(v, 9)
                            for k, v in state["utilization"].items()},
            "burn": {k: round(v, 9) for k, v in state["burn"].items()},
            "burning": state["burning"],
            "headroom_bytes": state["headroom_bytes"],
            "slope_per_s": state["slope_per_s"],
            "time_to_oom_s": state["time_to_oom_s"],
            "pressure": state["pressure"],
            "program_code_bytes": code,
            "program_workspace_bytes": workspace,
            "donated_saved_bytes": saved,
            "programs": self.programs(),
            "pools": pools,
        }
