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
  on.  Elastic resize (``min_ranks``, ``resize``, ``capacity_fn``) and
  ``checkpoint_dir`` threading re-shard checkpoints through
  ``core/checkpoint.py`` and raise ``NotImplementedError`` naming
  ROADMAP A5 before any process starts.

Telemetry: ``gang_restarts_total{task}``, ``gang_failures_total{task,
cause}``, ``gang_world_size{task}``, ``rank_heartbeat_age_seconds{rank}``
(live, from the launcher's watch loop); the fault registry's call log
records observed beats (``gang.heartbeat``), teardown signals
(``gang.teardown``) and restarts (``gang.restart``) when
``record_calls`` is set.
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
    """Whole-gang launcher: detect fast, tear down, relaunch.

    :meth:`run` returns the per-rank results of the first attempt that
    completes.  Left on the instance: ``restarts``, ``last_failure``
    (the last :class:`~.launcher.WorkerFailure`), ``monitor`` (the live
    attempt's detector), ``plane`` (the attempt's merged telemetry when
    the observability plane is on), ``last_postmortem`` (path of the
    bundle the last dead attempt left), ``world_size``."""

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
                 capacity_fn: Optional[Callable[[], int]] = None):
        from .launcher import ELASTIC_WAITS
        if (checkpoint_dir is not None or min_ranks is not None
                or capacity_fn is not None):
            raise NotImplementedError(
                "checkpoint_dir / min_ranks / capacity_fn: "
                + ELASTIC_WAITS)
        from .distributed import ClusterConfig, resolve_backend
        # the backend is checked before any process starts
        resolve_backend(ClusterConfig(num_processes=int(n_processes),
                                      backend=backend, device=device))
        self.task = task
        self.n_processes = int(n_processes)
        self.world_size = self.n_processes
        self.task_args = task_args
        self.timeout_s = float(timeout_s)
        self.env_extra = dict(env_extra or {})
        self.retry_policy = retry_policy
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.hang_intervals = float(hang_intervals)
        self.startup_grace_s = float(startup_grace_s)
        self.straggler_lag_steps = straggler_lag_steps
        self.device, self.backend = device, backend
        self.term_grace_s = float(term_grace_s)
        self.tail_lines = int(tail_lines)
        self.observability_dir = observability_dir
        if tm_interval_s is None:
            tm_interval_s = (self.heartbeat_interval_s
                             if observability_dir else 0.0)
        self.tm_interval_s = float(tm_interval_s)
        self.restarts = 0
        self.last_failure: Optional[BaseException] = None
        self.monitor: Optional[HeartbeatMonitor] = None
        self.plane: Optional[GangPlane] = None
        self.last_postmortem: Optional[str] = None
        reg = get_registry()
        self._c_restarts = reg.counter(
            "gang_restarts_total", "whole-gang relaunches", ("task",))
        self._c_failures = reg.counter(
            "gang_failures_total",
            "gang attempts that failed, by first-listed cause kind",
            ("task", "cause"))
        reg.gauge("gang_world_size",
                  "rank count of the live (or next) gang attempt",
                  ("task",)).set(self.world_size, task=self.task)

    def resize(self, n: int) -> None:
        """Elastic resize waits for ROADMAP A5 (``core/checkpoint.py``)."""
        from .launcher import ELASTIC_WAITS
        raise NotImplementedError(f"resize({n}): " + ELASTIC_WAITS)

    def _new_monitor(self) -> Optional[HeartbeatMonitor]:
        if self.heartbeat_interval_s <= 0:
            return None
        return HeartbeatMonitor(
            self.world_size, self.heartbeat_interval_s,
            hang_intervals=self.hang_intervals,
            startup_grace_s=self.startup_grace_s,
            straggler_lag_steps=self.straggler_lag_steps)

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
        """Remove an earlier attempt's flight rings: ``seq`` restarts per
        process, so a stale dump would outrank the new attempt's tail."""
        obs = self.observability_dir
        if not obs or not os.path.isdir(obs):
            return
        for r in range(self.world_size):
            try:
                os.unlink(os.path.join(obs, f"flight-rank{r}.json"))
            except FileNotFoundError:
                pass

    def _write_postmortem(self, attempt: int, failure) -> None:
        """One dead attempt → ``postmortem-attempt<N>.json`` and
        ``postmortem.json`` (the latest) in the obs dir, plus the
        stitched trace of whatever spans the wire delivered."""
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
            last_steps=last_steps, obs_dir=obs)
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
        """Every relaunch boundary invalidates the launcher's plan cache."""
        from .planner import get_planner
        get_planner().refresh(reason, world_size=self.world_size)

    def run(self) -> List[Any]:
        """Launch (and relaunch) until a gang completes → per-rank
        results in rank order, or the last attempt's failure when the
        retries run out."""
        from .launcher import WorkerFailure, _launch_once
        policy = self.retry_policy
        retries_left = policy.max_retries if policy else 0
        attempt = 0
        while True:
            self.monitor = self._new_monitor()
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
                    obs_dir=self.observability_dir)
                self._export_trace()
                return results
            except WorkerFailure as e:
                self.last_failure = e
                self._c_failures.inc(1, task=self.task,
                                     cause=self._cause_kind(e.causes))
                self._write_postmortem(attempt, e)
                if policy is None or retries_left <= 0 \
                        or not policy.acquire_retry():
                    raise
                retries_left -= 1
                self.restarts += 1
                self._c_restarts.inc(1, task=self.task)
                get_faults().note("gang.restart", attempt=attempt + 1,
                                  restart=self.restarts,
                                  causes=dict(e.causes))
                self._replan("relaunch")
                policy.sleep(policy.backoff_s(attempt),
                             site="launcher.backoff")
                attempt += 1
