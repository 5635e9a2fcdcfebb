"""Gang supervision: missed-heartbeat failure detection and whole-gang
relaunch.

The PyTorch port of the JAX package's ``parallel/supervisor.py``.  The
reference's NetworkManager treats worker loss as a whole-job event, and
a hung worker goes unnoticed until the global timeout.  Here:

- :class:`HeartbeatMonitor` — a phi-accrual-flavoured missed-heartbeat
  detector over the per-rank ``SMLMP_HB`` beats the launcher's reader
  threads feed it.  Suspicion is ``elapsed / expected interval``, the
  expected interval adapting to the observed mean inter-arrival; a rank
  is declared failed at ``hang_intervals`` missed beats.  Verdicts:
  ``hang at step N``, ``no heartbeat``, and the advisory ``straggler``.
  The clock is injectable.
- :class:`GangSupervisor` — one attempt is one whole gang (a formed
  process group cannot re-admit a replacement rank); on failure the
  launcher has torn every rank down and the supervisor relaunches under
  the caller's :class:`~synapseml_tpu_torch.resilience.RetryPolicy` with
  a fresh coordinator port, writes a post-mortem bundle per dead attempt
  and exports the stitched gang trace when the observability plane is
  on.  A ``checkpoint_dir`` threads to every worker (``SMLTPU_CKPT_DIR``),
  so trainers that checkpoint (GBDT, DL) resume from the last complete
  step; ``last_recovery_s`` clocks the kill to the relaunched gang's
  first beat at the failed attempt's highest step.
- **Elastic resize**: with ``min_ranks`` set, a rank blamed in
  ``shrink_after`` consecutive failed attempts shrinks the next
  relaunch to the largest healthy size ≥ ``min_ranks``; :meth:`resize`
  (a running attempt is torn down at the next watch poll) and
  ``capacity_fn`` shrink or grow it at a launch boundary.  Checkpoints
  are world-size-independent (the booster is its own state; a DL state
  is one card's), so an N-rank checkpoint resumes on M ranks.
- ``compile_cache_dir`` (the kernel build cache, :mod:`.compilecache`)
  and ``tune_table_dir`` thread to every worker the same way.

Telemetry: ``gang_restarts_total{task}``, ``gang_failures_total{task,
cause}``, ``gang_resizes_total{task,direction}``,
``gang_world_size{task}``, ``rank_heartbeat_age_seconds{rank}`` (live,
from the launcher's watch loop; departed ranks' series are removed);
the fault registry's call log records observed beats
(``gang.heartbeat``), teardown signals (``gang.teardown``), restarts
(``gang.restart``) and resizes (``gang.resize``) when ``record_calls``
is set.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

from ..resilience import RetryPolicy
from ..resilience.faults import get_faults
from ..telemetry import get_registry
from ..telemetry.gangplane import GangPlane, write_postmortem

__all__ = ["HeartbeatMonitor", "GangSupervisor", "RankHealth"]


@dataclass
class RankHealth:
    """Per-rank liveness state (launcher side)."""
    rank: int
    started: float
    beats: int = 0
    last_beat: Optional[float] = None
    last_step: Optional[int] = None
    #: EWMA of inter-arrival seconds (None until two beats)
    mean_interval: Optional[float] = None
    done: bool = False

    def snapshot(self) -> Dict[str, Any]:
        return {"rank": self.rank, "beats": self.beats,
                "last_step": self.last_step,
                "mean_interval": self.mean_interval, "done": self.done}


class HeartbeatMonitor:
    """Phi-style missed-heartbeat detector for one gang attempt.

    Thread-safe: the launcher's per-rank reader threads call
    :meth:`observe` while the watch loop polls :meth:`verdicts`.
    ``clock`` is injectable so tests drive time deterministically.
    """

    #: EWMA weight of the newest inter-arrival sample
    EWMA_ALPHA = 0.25

    def __init__(self, n_ranks: int, interval_s: float,
                 hang_intervals: float = 3.0,
                 startup_grace_s: float = 120.0,
                 straggler_lag_steps: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_observe: Optional[Callable[[int, Optional[int]], None]]
                 = None,
                 ranks: Optional[Iterable[int]] = None):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.interval_s = float(interval_s)
        self.hang_intervals = float(hang_intervals)
        self.startup_grace_s = float(startup_grace_s)
        self.straggler_lag_steps = straggler_lag_steps
        self._clock = clock
        self._on_observe = on_observe
        self._lock = threading.Lock()
        now = clock()
        # ``ranks`` lets a caller watch an explicit id set (gang ranks
        # are 0..n-1, so the supervisor never needs it)
        rank_ids = (list(ranks) if ranks is not None
                    else list(range(n_ranks)))
        self.ranks: Dict[int, RankHealth] = {
            r: RankHealth(rank=r, started=now) for r in rank_ids}

    # -- feeding -----------------------------------------------------------
    def observe(self, rank: int, step: Optional[int] = None,
                ts: Optional[float] = None) -> None:
        """One received beat (``ts`` is the sender's wall clock, carried
        for logs; detection uses the launcher's own monotonic clock)."""
        now = self._clock()
        with self._lock:
            h = self.ranks.get(rank)
            if h is None:
                return
            if h.last_beat is not None:
                d = now - h.last_beat
                h.mean_interval = (d if h.mean_interval is None else
                                   (1 - self.EWMA_ALPHA) * h.mean_interval
                                   + self.EWMA_ALPHA * d)
            h.last_beat = now
            h.beats += 1
            if step is not None and (h.last_step is None
                                     or step >= h.last_step):
                h.last_step = step
        get_faults().note("gang.heartbeat", rank=rank, step=step)
        if self._on_observe is not None:
            self._on_observe(rank, step)

    def mark_done(self, rank: int) -> None:
        """Rank exited cleanly: stop watching it (a finished rank is not
        a hung rank)."""
        with self._lock:
            h = self.ranks.get(rank)
            if h is not None:
                h.done = True

    # -- reading -----------------------------------------------------------
    def age(self, rank: int) -> float:
        """Seconds since this rank's last beat (since start when none)."""
        now = self._clock()
        with self._lock:
            h = self.ranks[rank]
            return now - (h.last_beat if h.last_beat is not None
                          else h.started)

    def ages(self) -> Dict[int, float]:
        now = self._clock()
        with self._lock:
            return {r: now - (h.last_beat if h.last_beat is not None
                              else h.started)
                    for r, h in self.ranks.items() if not h.done}

    def last_steps(self) -> Dict[int, Optional[int]]:
        with self._lock:
            return {r: h.last_step for r, h in self.ranks.items()}

    def max_step(self) -> Optional[int]:
        with self._lock:
            steps = [h.last_step for h in self.ranks.values()
                     if h.last_step is not None]
        return max(steps) if steps else None

    def _expected_interval(self, h: RankHealth) -> float:
        """The adaptive beat period: never tighter than the configured
        interval, stretched by the observed mean when the host is slow."""
        if h.mean_interval is None:
            return self.interval_s
        return max(self.interval_s, h.mean_interval)

    def suspicion(self, rank: int) -> float:
        """phi-style suspicion: elapsed beats-worth of silence (0 when
        the rank just beat; >= ``hang_intervals`` ⇒ declared failed)."""
        now = self._clock()
        with self._lock:
            h = self.ranks[rank]
            if h.done:
                return 0.0
            if h.last_beat is None:
                return 0.0
            return (now - h.last_beat) / self._expected_interval(h)

    def verdicts(self) -> Dict[int, str]:
        """rank → structured failure cause, for every rank the detector
        declares failed NOW (empty dict: gang looks alive)."""
        now = self._clock()
        out: Dict[int, str] = {}
        with self._lock:
            for r, h in self.ranks.items():
                if h.done:
                    continue
                if h.last_beat is None:
                    silent = now - h.started
                    if silent > self.startup_grace_s:
                        out[r] = f"no heartbeat (none in {silent:.1f}s)"
                    continue
                silent = now - h.last_beat
                phi = silent / self._expected_interval(h)
                if phi >= self.hang_intervals:
                    step = ("?" if h.last_step is None else h.last_step)
                    out[r] = (f"hang at step {step} (no heartbeat for "
                              f"{silent:.1f}s, {phi:.1f} intervals)")
        return out

    def stragglers(self) -> Dict[int, str]:
        """Advisory rank → cause for ranks alive but lagging the gang
        leader by more than ``straggler_lag_steps`` (empty when the
        feature is off or nobody lags)."""
        lag = self.straggler_lag_steps
        if lag is None:
            return {}
        with self._lock:
            steps = {r: h.last_step for r, h in self.ranks.items()
                     if not h.done and h.last_step is not None}
            if len(steps) < 2:
                return {}
            lead = max(steps.values())
            return {r: f"straggler at step {s} (leader at step {lead})"
                    for r, s in steps.items() if lead - s > lag}


class GangSupervisor:
    """Elastic whole-gang launcher: detect fast, tear down, relaunch,
    resume from the last complete checkpoint, and with a resize policy
    resize the gang instead of dying with it.

    :meth:`run` returns the per-rank results of the first attempt that
    completes.  Left on the instance: ``restarts``, ``last_failure``
    (the last :class:`~.launcher.WorkerFailure`), ``last_recovery_s``
    (seconds from a failure or resize teardown to the relaunched gang's
    first beat at the failed attempt's highest step, or to its
    completion), ``monitor`` (the live attempt's detector), ``plane``
    (the attempt's merged telemetry when the observability plane is on),
    ``last_postmortem`` (path of the bundle the last dead attempt left),
    ``world_size`` (the live attempt's rank count) and
    ``resize_history`` (every applied resize: ``{"attempt", "from",
    "to", "direction", "cause"}``).

    Elastic resize: ``min_ranks`` (in ``[1, n_processes]``) arms the
    shrink policy: when the SAME rank is blamed in ``shrink_after``
    consecutive failed attempts (a straggler advisory is never blamed),
    the next relaunch drops to the largest healthy size ≥ ``min_ranks``.
    :meth:`resize` requests a size for the next attempt (a running
    healthy attempt is torn down); ``capacity_fn`` (→ the placeable
    rank count) shrinks the gang or grows a degraded one back toward
    ``n_processes`` at each launch boundary.  Failure-driven shrinks
    spend a retry of the caller's ``retry_policy`` like any relaunch;
    automatic resizes also obey ``resize_cooldown_s`` between shrinks
    and the ``max_resizes`` budget."""

    def __init__(self, task: str, n_processes: int = 2,
                 task_args: Any = None, timeout_s: float = 300.0,
                 env_extra: Optional[Dict[str, str]] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 heartbeat_interval_s: float = 1.0,
                 hang_intervals: float = 3.0,
                 startup_grace_s: float = 120.0,
                 straggler_lag_steps: Optional[int] = None,
                 term_grace_s: float = 2.0,
                 tail_lines: int = 400,
                 observability_dir: Optional[str] = None,
                 tm_interval_s: Optional[float] = None,
                 device: str = "cuda", backend: Optional[str] = None,
                 checkpoint_dir: Optional[Any] = None,
                 min_ranks: Optional[int] = None,
                 shrink_after: int = 2,
                 resize_cooldown_s: float = 0.0,
                 max_resizes: int = 8,
                 capacity_fn: Optional[Callable[[], int]] = None,
                 compile_cache_dir: Optional[str] = None,
                 tune_table_dir: Optional[str] = None):
        from .distributed import ClusterConfig, resolve_backend
        # the backend is checked before any process starts
        resolve_backend(ClusterConfig(num_processes=int(n_processes),
                                      backend=backend, device=device))
        self.task = task
        self.n_processes = int(n_processes)
        self.task_args = task_args
        self.timeout_s = float(timeout_s)
        self.env_extra = dict(env_extra or {})
        self.retry_policy = retry_policy
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.hang_intervals = float(hang_intervals)
        self.startup_grace_s = float(startup_grace_s)
        self.straggler_lag_steps = straggler_lag_steps
        self.device, self.backend = device, backend
        # a CheckpointManager (anything with .directory) passes its
        # directory; a path passes through
        if checkpoint_dir is not None and not isinstance(
                checkpoint_dir, (str, os.PathLike)):
            checkpoint_dir = getattr(checkpoint_dir, "directory",
                                     checkpoint_dir)
        self.checkpoint_dir = (str(checkpoint_dir) if checkpoint_dir
                               else None)
        # the kernel build cache and the tuning table thread to every
        # worker (and every relaunch or resize) the same way
        self.compile_cache_dir = (str(compile_cache_dir)
                                  if compile_cache_dir else None)
        if self.compile_cache_dir:
            from .compilecache import COMPILE_CACHE_ENV
            self.env_extra.setdefault(COMPILE_CACHE_ENV,
                                      self.compile_cache_dir)
        self.tune_table_dir = str(tune_table_dir) if tune_table_dir else None
        if self.tune_table_dir:
            from ..telemetry.tunetable import TUNE_TABLE_ENV
            self.env_extra.setdefault(TUNE_TABLE_ENV, self.tune_table_dir)
        self.term_grace_s = float(term_grace_s)
        self.tail_lines = int(tail_lines)
        self.observability_dir = observability_dir
        if tm_interval_s is None:
            tm_interval_s = (self.heartbeat_interval_s
                             if observability_dir else 0.0)
        self.tm_interval_s = float(tm_interval_s)

        # -- elastic resize policy ----------------------------------------
        if min_ranks is not None:
            min_ranks = int(min_ranks)
            if not 1 <= min_ranks <= self.n_processes:
                raise ValueError(
                    f"min_ranks={min_ranks}: must be in "
                    f"[1, n_processes={self.n_processes}]")
        self.min_ranks = min_ranks
        self.shrink_after = max(1, int(shrink_after))
        self.resize_cooldown_s = float(resize_cooldown_s)
        self.max_resizes = int(max_resizes)
        self.capacity_fn = capacity_fn

        self.restarts = 0
        self.last_failure: Optional[BaseException] = None
        self.last_recovery_s: Optional[float] = None
        self.monitor: Optional[HeartbeatMonitor] = None
        self.plane: Optional[GangPlane] = None
        self.last_postmortem: Optional[str] = None
        self.world_size = self.n_processes
        self.resize_history: List[Dict[str, Any]] = []
        self._max_world = self.n_processes
        self._fail_streak: Dict[int, int] = {}
        self._resizes_done = 0
        self._last_shrink_at: Optional[float] = None
        self._resize_lock = threading.Lock()
        self._requested_size: Optional[int] = None
        self._interrupt = threading.Event()
        self._resize_listeners: List[Callable[[Dict[str, Any]], None]] = []
        self._recovery_pending = {"done": True}

        reg = get_registry()
        self._c_restarts = reg.counter(
            "gang_restarts_total", "whole-gang relaunches", ("task",))
        self._c_failures = reg.counter(
            "gang_failures_total",
            "gang attempts that failed, by first-listed cause kind",
            ("task", "cause"))
        self._c_resizes = reg.counter(
            "gang_resizes_total", "applied elastic gang resizes, by "
            "direction", ("task", "direction"))
        self._g_world = reg.gauge(
            "gang_world_size",
            "rank count of the live (or next) gang attempt", ("task",))
        self._g_world.set(self.world_size, task=self.task)

    def _new_monitor(self, watermark: Optional[int],
                     failed_at: Optional[float]
                     ) -> Optional[HeartbeatMonitor]:
        """The attempt's detector at the LIVE world size; its beats close
        the recovery clock at the first step ≥ ``watermark`` (any step
        when the dead attempt beat none: it died before its first beat)."""
        recovered = {"done": failed_at is None}
        self._recovery_pending = recovered
        if self.heartbeat_interval_s <= 0:
            return None

        def on_observe(rank: int, step: Optional[int]) -> None:
            if recovered["done"] or step is None or (
                    watermark is not None and step < watermark):
                return
            recovered["done"] = True
            self.last_recovery_s = time.monotonic() - failed_at

        return HeartbeatMonitor(
            self.world_size, self.heartbeat_interval_s,
            hang_intervals=self.hang_intervals,
            startup_grace_s=self.startup_grace_s,
            straggler_lag_steps=self.straggler_lag_steps,
            on_observe=on_observe)

    #: verdict prefix → metric label for gang_failures_total{cause}
    _CAUSE_KINDS = (("hang", "hang"), ("no heartbeat", "no_heartbeat"),
                    ("exit", "exit"), ("timeout", "timeout"),
                    ("no result", "no_result"), ("straggler", "straggler"),
                    ("injected", "injected"))

    @classmethod
    def _cause_kind(cls, causes: Dict[int, str]) -> str:
        if not causes:
            return "unknown"
        first = causes[sorted(causes)[0]]
        for prefix, kind in cls._CAUSE_KINDS:
            if first.startswith(prefix):
                return kind
        return "other"

    def _clear_flight_dumps(self) -> None:
        """Remove an earlier attempt's flight rings (of every size the
        gang has had): ``seq`` restarts per process, so a stale dump
        would outrank the new attempt's tail."""
        obs = self.observability_dir
        if not obs or not os.path.isdir(obs):
            return
        for r in range(self._max_world):
            try:
                os.unlink(os.path.join(obs, f"flight-rank{r}.json"))
            except FileNotFoundError:
                pass

    def _write_postmortem(self, attempt: int, failure) -> None:
        """One dead attempt → ``postmortem-attempt<N>.json`` and
        ``postmortem.json`` (the latest) in the obs dir, with the
        attempt's world size and the resizes so far, plus the stitched
        trace of whatever spans the wire delivered."""
        obs = self.observability_dir
        if not obs:
            return
        from ..telemetry.artifact import write_json
        from ..telemetry.gangplane import check_postmortem
        os.makedirs(obs, exist_ok=True)
        last_steps = (self.monitor.last_steps()
                      if self.monitor is not None else {})
        bundle = write_postmortem(
            os.path.join(obs, f"postmortem-attempt{attempt}.json"),
            task=self.task, causes=dict(failure.causes), attempt=attempt,
            n_ranks=self.world_size, plane=self.plane,
            last_steps=last_steps, obs_dir=obs,
            resize_history=list(self.resize_history))
        latest = os.path.join(obs, "postmortem.json")
        write_json(latest, bundle, schema=check_postmortem)
        self.last_postmortem = latest
        self._export_trace()

    def _export_trace(self) -> None:
        obs = self.observability_dir
        if obs and self.plane is not None:
            os.makedirs(obs, exist_ok=True)
            self.plane.export_chrome(os.path.join(obs, "gang_trace.json"))

    def _replan(self, reason: str) -> None:
        """Every relaunch or resize boundary invalidates the plan cache."""
        from .planner import get_planner
        get_planner().refresh(reason, world_size=self.world_size)

    # -- elastic resize ----------------------------------------------------
    def resize(self, n: int) -> None:
        """Request ``n`` ranks from the next attempt on.  Thread-safe and
        callable mid-run: a running healthy attempt is torn down at the
        next watch poll and relaunched at the new size from the last
        durable checkpoint.  An explicit request bypasses the automatic
        budget and cooldown, not the floor: ``n < 1`` and
        ``n < min_ranks`` raise ``ValueError``.  A request for the
        current size cancels a pending one."""
        n = int(n)
        if n < 1:
            raise ValueError(
                f"resize({n}): a gang needs at least one rank — to stop "
                "the gang, let the task finish or tear the supervisor "
                "down; resize only changes a LIVE gang's shape")
        if self.min_ranks is not None and n < self.min_ranks:
            raise ValueError(
                f"resize({n}): below this supervisor's elastic floor "
                f"min_ranks={self.min_ranks} — shrink requests must stay "
                f"in [{self.min_ranks}, ...]; raise min_ranks at "
                "construction if the floor itself is wrong")
        with self._resize_lock:
            if n == self.world_size:
                self._requested_size = None
                self._interrupt.clear()
                return
            # the wakeup is set under the lock that consumes the request,
            # so a request cannot tear down the next, already resized
            # attempt
            self._requested_size = n
            self._interrupt.set()

    def add_resize_listener(self, fn: Callable[[Dict[str, Any]],
                                               None]) -> None:
        """Call ``fn(event)`` on every APPLIED resize (requested,
        failure-driven or capacity-driven), with the event
        :attr:`resize_history` records.  A listener's error is
        swallowed: accounting must not break the relaunch."""
        with self._resize_lock:
            self._resize_listeners.append(fn)

    def _apply_resize(self, attempt: int, new_size: int, cause: str,
                      automatic: bool) -> None:
        with self._resize_lock:
            old = self.world_size
            if new_size == old:
                return
            direction = "shrink" if new_size < old else "grow"
            self.world_size = new_size
        self._max_world = max(self._max_world, new_size)
        if automatic:
            self._resizes_done += 1
            if direction == "shrink":
                self._last_shrink_at = time.monotonic()
        # ranks renumber 0..new-1 on relaunch: old streaks would blame
        # the wrong process
        self._fail_streak.clear()
        event = {"attempt": int(attempt), "from": old, "to": new_size,
                 "direction": direction, "cause": cause}
        self.resize_history.append(event)
        self._c_resizes.inc(1, task=self.task, direction=direction)
        self._g_world.set(new_size, task=self.task)
        with self._resize_lock:
            listeners = list(self._resize_listeners)
        for fn in listeners:
            try:
                fn(dict(event))
            except Exception:  # noqa: BLE001 — accounting is advisory
                pass
        get_faults().note("gang.resize", **event)
        from ..telemetry.flight import record as flight_record
        flight_record("gang_resize", task=self.task, **event)
        self._replan(f"resize_{direction}")

    def _resize_budget_ok(self) -> bool:
        return self._resizes_done < self.max_resizes

    def _shrink_cooled_down(self) -> bool:
        """The cooldown gate of every AUTOMATIC shrink, failure- and
        capacity-driven alike."""
        return (self._last_shrink_at is None
                or time.monotonic() - self._last_shrink_at
                >= self.resize_cooldown_s)

    def _plan_after_failure(self, causes: Dict[int, str]) -> Optional[int]:
        """Shrink-to-survive for one failed attempt → target size, or
        None.  A rank is persistently failing once it is blamed (any
        cause but the ``straggler`` advisory) in ``shrink_after``
        consecutive failed attempts; the target is the largest healthy
        size ≥ ``min_ranks``."""
        blamed = {r for r, c in causes.items()
                  if not str(c).startswith("straggler")}
        for r in list(self._fail_streak):
            if r not in blamed:
                del self._fail_streak[r]
        for r in blamed:
            self._fail_streak[r] = self._fail_streak.get(r, 0) + 1
        if self.min_ranks is None:
            return None
        persistent = [r for r in blamed
                      if self._fail_streak[r] >= self.shrink_after]
        if not persistent:
            return None
        target = max(self.min_ranks, self.world_size - len(persistent))
        if target >= self.world_size or not self._resize_budget_ok() \
                or not self._shrink_cooled_down():
            return None
        return target

    def _plan_before_launch(self, attempt: int) -> None:
        """Launch-boundary resizes: a :meth:`resize` request first, else
        ``capacity_fn`` shrinks a gang whose capacity left or grows a
        degraded one back toward ``n_processes``."""
        with self._resize_lock:
            req = self._requested_size
            self._requested_size = None
            # consuming the request consumes its wakeup
            self._interrupt.clear()
        if req is not None:
            self._apply_resize(attempt, req, cause="requested",
                               automatic=False)
            return
        if self.capacity_fn is None:
            return
        try:
            cap = int(self.capacity_fn())
        except Exception:  # noqa: BLE001 — a flaky probe must not kill the job
            return
        floor = self.min_ranks if self.min_ranks is not None else 1
        if cap < self.world_size:
            target = max(floor, cap)
            if (target < self.world_size and self._resize_budget_ok()
                    and self._shrink_cooled_down()):
                self._apply_resize(attempt, target,
                                   cause=f"capacity {cap}", automatic=True)
        elif self.world_size < self.n_processes and cap > self.world_size:
            target = min(self.n_processes, cap)
            if self._resize_budget_ok():
                self._apply_resize(attempt, target,
                                   cause=f"capacity {cap}", automatic=True)

    def run(self) -> List[Any]:
        """Launch (and relaunch or resize) until a gang completes → the
        per-rank results in rank order (as many as the completing
        attempt's ``world_size``), or the last attempt's failure when the
        retries run out."""
        from .launcher import GangInterrupted, WorkerFailure, _launch_once
        policy = self.retry_policy
        retries_left = policy.max_retries if policy else 0
        watermark: Optional[int] = None
        failed_at: Optional[float] = None
        attempt = 0
        while True:
            self._plan_before_launch(attempt)
            self.monitor = self._new_monitor(watermark, failed_at)
            self.plane = (GangPlane(self.world_size)
                          if (self.tm_interval_s > 0
                              or self.observability_dir) else None)
            self._clear_flight_dumps()
            try:
                results = _launch_once(
                    self.task, self.world_size, self.task_args,
                    self.timeout_s, self.env_extra, device=self.device,
                    backend=self.backend, monitor=self.monitor,
                    heartbeat_interval_s=self.heartbeat_interval_s,
                    term_grace_s=self.term_grace_s,
                    tail_lines=self.tail_lines, plane=self.plane,
                    tm_interval_s=self.tm_interval_s,
                    obs_dir=self.observability_dir,
                    checkpoint_dir=self.checkpoint_dir,
                    interrupt=self._interrupt)
                if failed_at is not None \
                        and not self._recovery_pending["done"]:
                    # no beat reached the watermark (the dead attempt's
                    # best step was its last): completion is the recovery
                    self.last_recovery_s = time.monotonic() - failed_at
                self._export_trace()
                return results
            except GangInterrupted:
                # a resize teardown: no retry spent, no post-mortem; the
                # recovery clock starts
                failed_at = time.monotonic()
                watermark = self._watermark(watermark)
                self.restarts += 1
                self._c_restarts.inc(1, task=self.task)
                get_faults().note("gang.restart", attempt=attempt,
                                  restart=self.restarts, causes={},
                                  watermark=watermark, resize=True)
                self._replan("relaunch")
                continue
            except WorkerFailure as e:
                self.last_failure = e
                failed_at = time.monotonic()
                watermark = self._watermark(watermark)
                self._c_failures.inc(1, task=self.task,
                                     cause=self._cause_kind(e.causes))
                self._write_postmortem(attempt, e)
                target = self._plan_after_failure(e.causes)
                if policy is None or retries_left <= 0 \
                        or not policy.acquire_retry():
                    raise
                retries_left -= 1
                if target is not None:
                    self._apply_resize(attempt, target,
                                       cause=self._cause_kind(e.causes),
                                       automatic=True)
                self.restarts += 1
                self._c_restarts.inc(1, task=self.task)
                get_faults().note("gang.restart", attempt=attempt + 1,
                                  restart=self.restarts,
                                  causes=dict(e.causes),
                                  watermark=watermark)
                self._replan("relaunch")
                policy.sleep(policy.backoff_s(attempt),
                             site="launcher.backoff")
                attempt += 1

    def _watermark(self, watermark: Optional[int]) -> Optional[int]:
        """The highest step any attempt so far beat."""
        step = self.monitor.max_step() if self.monitor is not None else None
        if step is not None and (watermark is None or step > watermark):
            return step
        return watermark
