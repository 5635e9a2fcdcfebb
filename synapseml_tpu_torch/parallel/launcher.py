"""Local multi-process launcher — the coordinating half of the rendezvous.

The PyTorch port of the JAX package's ``parallel/launcher.py``.  The
reference's coordinating process opens a ServerSocket, waits for every
worker task to phone home, then broadcasts the machine list so the
native ring can form.  Here the launcher reserves the coordinator port
(:class:`ReservedPort`), starts one OS process per rank
(``python -m synapseml_tpu_torch.parallel.worker``), and each rank joins
a ``torch.distributed`` group through a ``TCPStore`` at that port; the
launcher watches the ranks and collects their results.  One device per
rank: ``device="cpu"`` ranks form a gloo group (the tests'
layout); ``device="cuda"`` ranks form an NCCL group, one card each, or
with ``backend="gloo"`` share cards (the one-card layout).

Supervision: every worker emits ``SMLMP_HB`` heartbeat lines on the pipe
that carries its result; the launcher's watch loop feeds them to a
:class:`~.supervisor.HeartbeatMonitor`, so a dead or hung rank fails the
attempt in O(heartbeat interval).  A failed attempt tears the gang down
(SIGTERM → grace → SIGKILL) and raises :class:`WorkerFailure` with a
per-rank cause map (``timeout`` / ``exit <code>`` / ``no result`` /
``hang at step N`` / ``no heartbeat`` / advisory ``straggler``) and every
rank's log tail.  A :class:`~synapseml_tpu_torch.resilience.RetryPolicy`
relaunches the whole gang (fresh port, fresh processes) through
:class:`~.supervisor.GangSupervisor`; with ``checkpoint_dir`` threaded
to every rank (``SMLTPU_CKPT_DIR``), checkpointing trainers resume from
the last complete step instead of step 0, and the supervisor may resize
the gang between attempts (a driver-requested teardown is
:class:`GangInterrupted`, not a failure).
"""

from __future__ import annotations

import collections
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ..resilience import RetryPolicy, get_faults
from ..telemetry import get_registry
from ..telemetry.gangplane import (OBS_DIR_ENV, TM_INTERVAL_ENV,
                                   parse_telemetry)
from .heartbeat import HB_INTERVAL_ENV, parse_heartbeat

#: marker the worker prints in front of its JSON result line
RESULT_MARKER = "SMLMP_RESULT:"

#: ring-buffer depth of retained log lines per rank
DEFAULT_TAIL_LINES = 400
#: per-line retention cap
_MAX_LINE_CHARS = 4096

#: env var carrying the worker-side rendezvous watchdog deadline
RENDEZVOUS_TIMEOUT_ENV = "SMLTPU_RENDEZVOUS_TIMEOUT_S"

#: env var carrying the checkpoint directory to every worker
CKPT_DIR_ENV = "SMLTPU_CKPT_DIR"


class ReservedPort:
    """A free TCP port that STAYS bound until :meth:`release`.

    A close-then-rebind probe races: between the launcher closing its probe
    socket and rank 0's ``TCPStore`` binding the port, another process
    (another test worker's gang) could grab it.  Holding the socket
    (``SO_REUSEADDR`` + ``SO_REUSEPORT`` where available) keeps the
    kernel from handing the port to anyone else for the whole spawn
    window; the launcher releases it only after every worker process
    exists, leaving the sliver between release and rank 0's bind (rank 0
    still has its interpreter and torch import ahead of it then)."""

    def __init__(self, host: str = "127.0.0.1"):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            try:
                self._sock.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEPORT, 1)
            except OSError:
                pass
        self._sock.bind((host, 0))
        self.host = host
        self.port = self._sock.getsockname()[1]

    @property
    def held(self) -> bool:
        return self._sock is not None

    def release(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self) -> "ReservedPort":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def find_free_port() -> int:
    """Ask the kernel for a free TCP port.  Kept for compatibility;
    prefer :class:`ReservedPort`, which holds the bind open instead of
    close-then-rebind (the race this function cannot avoid)."""
    with ReservedPort() as rp:
        return rp.port


def _rank_causes(returncodes: Dict[int, Optional[int]],
                 timed_out: Sequence[int],
                 missing_result: Sequence[int],
                 extra: Optional[Dict[int, str]] = None) -> Dict[int, str]:
    """Structured per-rank failure causes (only failed ranks appear).
    ``extra`` (heartbeat verdicts / straggler advisories) wins over the
    generic exit-code causes — 'hang at step 3' beats 'exit -9'."""
    causes: Dict[int, str] = dict(extra or {})
    for r in timed_out:
        causes.setdefault(r, "timeout")
    for r, rc in returncodes.items():
        if r not in causes and rc not in (0, None):
            causes[r] = f"exit {rc}"
    for r in missing_result:
        causes.setdefault(r, "no result")
    return causes


class WorkerFailure(RuntimeError):
    """A worker exited non-zero, timed out, hung, or produced no result.

    ``causes`` maps failed rank → cause string; ``logs`` maps every rank
    → its captured output tail (ring-buffered)."""

    def __init__(self, msg: str, logs: Dict[int, str],
                 causes: Optional[Dict[int, str]] = None):
        self.causes = dict(causes or {})
        if self.causes:
            msg += "\nper-rank causes: " + ", ".join(
                f"rank {r}: {c}" for r, c in sorted(self.causes.items()))
        super().__init__(msg + "\n" + "\n".join(
            f"--- rank {r} log (tail) ---\n{t[-4000:]}" for r, t in logs.items()))
        self.logs = logs


class GangInterrupted(RuntimeError):
    """The launcher tore a healthy gang down on purpose: the supervisor's
    elastic ``resize()`` boundary, not a failure."""


class _RankReader(threading.Thread):
    """Per-rank pipe drain: parses heartbeat/result markers on the fly
    and retains only a bounded tail of raw lines.

    A rank that fills the OS pipe buffer mid-collective would deadlock
    the whole cluster if nobody read its pipe, and on failure we want
    EVERY rank's tail, not just the first one waited on — but a chatty
    rank streaming millions of lines must not grow the launcher without
    limit, hence the ring buffer."""

    def __init__(self, rank: int, proc: subprocess.Popen,
                 monitor=None, plane=None,
                 tail_lines: int = DEFAULT_TAIL_LINES):
        super().__init__(name=f"rank-reader-{rank}", daemon=True)
        self.rank = rank
        self.proc = proc
        self.monitor = monitor
        self.plane = plane
        self.tail: "collections.deque[str]" = collections.deque(
            maxlen=max(1, tail_lines))
        self.result_line: Optional[str] = None
        self.dropped = 0

    def run(self) -> None:
        stream = self.proc.stdout
        if stream is None:
            return
        for line in stream:
            line = line.rstrip("\n")
            hb = parse_heartbeat(line)
            if hb is not None:
                if self.monitor is not None:
                    self.monitor.observe(self.rank, step=hb.get("step"),
                                         ts=hb.get("ts"))
                continue                       # beats never enter the tail
            tm = parse_telemetry(line)
            if tm is not None:
                # telemetry batches feed the gang plane and never enter
                # the tail (one batch can be tens of KB of metrics/spans)
                if self.plane is not None:
                    self.plane.ingest(self.rank, tm)
                continue
            if line.startswith(RESULT_MARKER):
                # the result must survive any amount of later chatter,
                # so it is captured out-of-band from the ring
                self.result_line = line
            if len(self.tail) == self.tail.maxlen:
                self.dropped += 1
            self.tail.append(line[:_MAX_LINE_CHARS])

    def text(self) -> str:
        head = (f"... ({self.dropped} earlier lines dropped)\n"
                if self.dropped else "")
        return head + "\n".join(self.tail)


def _teardown_gang(procs: List[subprocess.Popen],
                   term_grace_s: float = 2.0) -> None:
    """SIGTERM every live rank, give the gang ``term_grace_s`` to unwind
    (flush logs, run finally blocks), then SIGKILL whatever remains — a
    rank blocked inside a native collective never sees the SIGTERM, which
    is exactly why the KILL follows."""
    faults = get_faults()
    alive = [p for p in procs if p.poll() is None]
    for p in alive:
        try:
            p.send_signal(signal.SIGTERM)
            faults.note("gang.teardown", pid=p.pid, sig="SIGTERM")
        except OSError:
            pass
    deadline = time.monotonic() + max(0.0, term_grace_s)
    while alive and time.monotonic() < deadline:
        alive = [p for p in alive if p.poll() is None]
        if alive:
            time.sleep(0.02)
    for p in alive:
        if p.poll() is None:
            try:
                p.kill()
                faults.note("gang.teardown", pid=p.pid, sig="SIGKILL")
            except OSError:
                pass


def _launch_once(task: str, n_processes: int, task_args: Any,
                 timeout_s: float, env_extra: Optional[Dict[str, str]], *,
                 device: str = "cuda", backend: Optional[str] = None,
                 monitor=None, heartbeat_interval_s: float = 0.0,
                 term_grace_s: float = 2.0,
                 tail_lines: int = DEFAULT_TAIL_LINES,
                 plane=None, tm_interval_s: float = 0.0,
                 obs_dir: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 interrupt: Optional[threading.Event] = None) -> List[Any]:
    """One rendezvous attempt: spawn, watch (heartbeats + exits + global
    deadline + the driver's ``interrupt``), collect (or tear down and
    raise WorkerFailure, or GangInterrupted when ``interrupt`` was set)."""
    if get_faults().check("launcher.attempt") is not None:
        raise WorkerFailure("injected rendezvous failure", {},
                            causes={r: "injected" for r in range(n_processes)})
    reserved = ReservedPort()
    coordinator = f"{reserved.host}:{reserved.port}"
    procs: List[subprocess.Popen] = []
    readers: List[_RankReader] = []
    args_json = json.dumps(task_args)
    pythonpath = os.pathsep.join(
        [p for p in sys.path if p and os.path.isdir(p)])
    reg = get_registry()
    g_hb_age = reg.gauge("rank_heartbeat_age_seconds",
                         "seconds since each rank's last heartbeat "
                         "(live gang attempts only)", ("rank",))
    try:
        try:
            for rank in range(n_processes):
                env = dict(os.environ)
                env.update(env_extra or {})
                env.update({
                    "SMLTPU_COORDINATOR": coordinator,
                    "SMLTPU_NUM_PROCESSES": str(n_processes),
                    "SMLTPU_PROCESS_ID": str(rank),
                    "LOCAL_RANK": str(rank),
                    "LOCAL_WORLD_SIZE": str(n_processes),
                    "SMLTPU_DEVICE": str(device),
                    "SMLTPU_BACKEND": backend or "",
                    "SMLTPU_TASK": task,
                    "SMLTPU_TASK_ARGS": args_json,
                    "SMLTPU_COLLECTIVE_TIMEOUT_S": str(timeout_s),
                    "PYTHONPATH": pythonpath,
                })
                if heartbeat_interval_s > 0:
                    env[HB_INTERVAL_ENV] = str(heartbeat_interval_s)
                    env.setdefault(RENDEZVOUS_TIMEOUT_ENV, str(timeout_s))
                if tm_interval_s > 0:
                    env[TM_INTERVAL_ENV] = str(tm_interval_s)
                if obs_dir:
                    env[OBS_DIR_ENV] = str(obs_dir)
                if checkpoint_dir:
                    env[CKPT_DIR_ENV] = str(checkpoint_dir)
                p = subprocess.Popen(
                    [sys.executable, "-m",
                     "synapseml_tpu_torch.parallel.worker"],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, env=env)
                procs.append(p)
                r = _RankReader(rank, p, monitor=monitor, plane=plane,
                                tail_lines=tail_lines)
                r.start()
                readers.append(r)
        finally:
            # held for the whole spawn window, then handed to rank 0
            reserved.release()

        deadline = time.monotonic() + timeout_s
        poll_s = (min(0.25, heartbeat_interval_s / 4.0)
                  if heartbeat_interval_s > 0 else 0.05)
        timed_out: List[int] = []
        hb_causes: Dict[int, str] = {}
        interrupted = False
        while True:
            if interrupt is not None and interrupt.is_set():
                # a driver-requested teardown (elastic resize): not a
                # failure; the relaunch at the new size resumes from the
                # last durable checkpoint
                interrupted = True
                break
            running = []
            failed_exit = False
            for rank, p in enumerate(procs):
                rc = p.poll()
                if rc is None:
                    running.append(rank)
                elif rc == 0:
                    if monitor is not None:
                        monitor.mark_done(rank)
                else:
                    failed_exit = True
            if failed_exit:
                # one dead rank wedges every peer inside its blocked
                # collectives: fail the gang now, not at the timeout
                break
            if not running:
                break
            if monitor is not None:
                # a rank that delivered its result is done: its beats may
                # stop while the process shuts down
                for r in readers:
                    if r.result_line is not None:
                        monitor.mark_done(r.rank)
                for rank, age in monitor.ages().items():
                    g_hb_age.set(age, rank=str(rank))
                hb_causes = monitor.verdicts()
                if hb_causes:
                    break
            if time.monotonic() >= deadline:
                timed_out = running
                break
            time.sleep(poll_s)

        # snapshot exits BEFORE tearing down: a rank WE kill must not be
        # blamed with its teardown signal
        returncodes = {rank: p.poll() for rank, p in enumerate(procs)}
        if interrupted or timed_out or hb_causes or any(
                rc not in (0, None) for rc in returncodes.values()):
            _teardown_gang(procs, term_grace_s=term_grace_s)
        for r in readers:
            r.join(timeout=10.0)
        logs = {r.rank: r.text() for r in readers}
        if interrupted:
            raise GangInterrupted(
                "gang torn down by driver request (elastic resize)")
        stragglers = monitor.stragglers() if monitor is not None else {}

        def _with_steps(causes: Dict[int, str]) -> Dict[int, str]:
            if monitor is None:
                return causes
            steps = monitor.last_steps()
            return {r: (c if "step" in c or steps.get(r) is None
                        else f"{c} (last step {steps[r]})")
                    for r, c in causes.items()}

        if hb_causes:
            raise WorkerFailure(
                f"ranks {sorted(hb_causes)} declared failed by the "
                "heartbeat detector", logs,
                causes=_with_steps(_rank_causes(
                    returncodes, [], [], extra={**stragglers, **hb_causes})))
        if timed_out:
            raise WorkerFailure(
                f"ranks {timed_out} timed out after {timeout_s:.0f}s", logs,
                causes=_with_steps(_rank_causes(returncodes, timed_out, [],
                                                extra=stragglers)))
        failed = [r for r, rc in returncodes.items() if rc not in (0, None)]
        if failed:
            raise WorkerFailure(
                f"ranks {failed} exited non-zero", logs,
                causes=_with_steps(_rank_causes(returncodes, [], [],
                                                extra=stragglers)))
        results: List[Any] = []
        missing: List[int] = []
        for r in readers:
            if r.result_line is None:
                missing.append(r.rank)
                results.append(None)
            else:
                results.append(json.loads(
                    r.result_line[len(RESULT_MARKER):]))
        if missing:
            raise WorkerFailure(
                f"ranks {missing} produced no result", logs,
                causes=_rank_causes(returncodes, [], missing))
        return results
    finally:
        reserved.release()
        _teardown_gang(procs, term_grace_s=0.0)
        if monitor is not None:
            # removed, not zeroed: after a shrink the departed ranks
            # leave no series behind
            for rank in range(n_processes):
                g_hb_age.remove(rank=str(rank))


def run_on_local_cluster(task: str,
                         n_processes: int = 2,
                         task_args: Any = None,
                         timeout_s: float = 300.0,
                         env_extra: Optional[Dict[str, str]] = None,
                         retry_policy: Optional[RetryPolicy] = None,
                         heartbeat_interval_s: float = 1.0,
                         hang_intervals: float = 3.0,
                         startup_grace_s: float = 120.0,
                         straggler_lag_steps: Optional[int] = None,
                         term_grace_s: float = 2.0,
                         tail_lines: int = DEFAULT_TAIL_LINES,
                         observability_dir: Optional[str] = None,
                         tm_interval_s: Optional[float] = None,
                         device: str = "cuda",
                         backend: Optional[str] = None,
                         checkpoint_dir: Optional[Any] = None,
                         min_ranks: Optional[int] = None,
                         shrink_after: int = 2,
                         resize_cooldown_s: float = 0.0,
                         max_resizes: int = 8,
                         capacity_fn=None) -> List[Any]:
    """Run ``module:function`` on a real ``n_processes``-rank
    ``torch.distributed`` gang on this host; → the per-rank results in
    rank order.  The function takes the JSON ``task_args`` and returns
    something JSON-serializable.

    ``device`` / ``backend`` pick the layout (see the module docstring);
    the backend is checked against the device and the cards BEFORE any
    process starts (nccl with more ranks than cards raises).
    ``timeout_s`` bounds the attempt and is the group's collective
    timeout.  Supervision is on by default (``heartbeat_interval_s=1``):
    a dead or hung rank fails the attempt within ``hang_intervals``
    beats.  ``retry_policy`` relaunches the whole gang on
    :class:`WorkerFailure`.  ``observability_dir`` turns the gang plane
    on (wire export, flight dumps, ``postmortem.json``,
    ``gang_trace.json``).  ``checkpoint_dir`` (a path or a
    :class:`~synapseml_tpu_torch.core.checkpoint.CheckpointManager`)
    reaches every worker as ``SMLTPU_CKPT_DIR`` so checkpointing trainers
    resume instead of restarting.

    Elastic resize (see :class:`~.supervisor.GangSupervisor`):
    ``min_ranks < n_processes`` lets the job shrink to the largest
    healthy size ≥ ``min_ranks`` when the same rank fails
    ``shrink_after`` consecutive attempts (under ``resize_cooldown_s``
    and ``max_resizes``), and ``capacity_fn`` (→ placeable rank count)
    shrinks or grows the gang at the next relaunch boundary.  Keep a
    :class:`~.supervisor.GangSupervisor` instead for mid-run
    ``resize(n)`` requests."""
    from .supervisor import GangSupervisor
    return GangSupervisor(
        task, n_processes=n_processes, task_args=task_args,
        timeout_s=timeout_s, env_extra=env_extra, retry_policy=retry_policy,
        heartbeat_interval_s=heartbeat_interval_s,
        hang_intervals=hang_intervals, startup_grace_s=startup_grace_s,
        straggler_lag_steps=straggler_lag_steps,
        term_grace_s=term_grace_s, tail_lines=tail_lines,
        observability_dir=observability_dir, tm_interval_s=tm_interval_s,
        device=device, backend=backend,
        checkpoint_dir=checkpoint_dir, min_ranks=min_ranks,
        shrink_after=shrink_after, resize_cooldown_s=resize_cooldown_s,
        max_resizes=max_resizes, capacity_fn=capacity_fn).run()
