"""Worker entry point for the multi-process launcher.

The PyTorch port of the JAX package's ``parallel/worker.py``.  One OS
process per rank: read the rank's :class:`~.distributed.ClusterConfig`
from the environment the launcher set, start the heartbeat and telemetry
emitters BEFORE the rendezvous (so the launcher tells "still importing"
from "wedged" from "never started"), rendezvous through
:func:`~.distributed.initialize_cluster`, run the task, and print its
JSON result behind ``SMLMP_RESULT:``.

Environment (set by :func:`~.launcher.run_on_local_cluster`):
``SMLTPU_COORDINATOR``, ``SMLTPU_NUM_PROCESSES``, ``SMLTPU_PROCESS_ID``,
``SMLTPU_DEVICE``, ``SMLTPU_BACKEND``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``SMLTPU_TASK`` (``module:function``),
``SMLTPU_TASK_ARGS`` (JSON), ``SMLTPU_COLLECTIVE_TIMEOUT_S``
(the process group's collective timeout), and optionally
``SMLTPU_HB_INTERVAL_S``, ``SMLTPU_RENDEZVOUS_TIMEOUT_S`` (a watchdog
around the rendezvous: a coordinator that never answers becomes a
:class:`~.collectives.CollectiveTimeout`), ``SMLTPU_TM_INTERVAL_S`` and
``SMLTPU_OBS_DIR`` (the flight ring dumps there on SIGTERM, the signal a
failing gang's healthy ranks receive, and on a clean exit),
``SMLTPU_CKPT_DIR`` (the gang's checkpoint directory; tasks read it and
resume from the newest checkpoint there), ``SMLTPU_COMPILE_CACHE_DIR``
(the kernel build cache: enabled before the rendezvous, so the task's
kernels load from and build into it; :mod:`.compilecache`) and
``SMLTPU_TUNE_TABLE_DIR`` (the tuning table the task's plane reads).

Run as ``python -m synapseml_tpu_torch.parallel.worker``.
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import sys


def _install_flight_dump(rank: int):
    """SIGTERM → dump the flight ring, then exit 143 without unwinding
    (the rank may be parked in a dead collective).  → the dump callable
    for the clean path, or None when no obs dir is configured."""
    from ..telemetry.gangplane import OBS_DIR_ENV
    obs_dir = os.environ.get(OBS_DIR_ENV)
    if not obs_dir:
        return None
    from ..telemetry.flight import get_flight
    path = os.path.join(obs_dir, f"flight-rank{rank}.json")

    def dump() -> None:
        try:
            get_flight().dump(path, rank=rank)
        except OSError:
            pass                # a failed dump must not mask the teardown

    def on_term(signum, frame):  # pragma: no cover - signal path
        dump()
        os._exit(143)

    signal.signal(signal.SIGTERM, on_term)
    return dump


def main() -> int:
    rank = int(os.environ["SMLTPU_PROCESS_ID"])
    import torch
    # one intra-op thread a rank: the gang's ranks share the host's cores
    torch.set_num_threads(1)
    from . import heartbeat
    emitter = heartbeat.start_emitter(rank)
    from ..telemetry import gangplane
    tm_emitter = gangplane.start_emitter(rank)
    flight_dump = _install_flight_dump(rank)
    # the kernel build cache, before anything loads a kernel; without the
    # variable this only installs the build attribution
    from .compilecache import enable_from_env
    enable_from_env()

    from .distributed import ClusterConfig, initialize_cluster, \
        shutdown_cluster
    n = int(os.environ["SMLTPU_NUM_PROCESSES"])
    cfg = ClusterConfig(
        coordinator_address=os.environ["SMLTPU_COORDINATOR"],
        num_processes=n, process_id=rank,
        backend=os.environ.get("SMLTPU_BACKEND") or None,
        device=os.environ.get("SMLTPU_DEVICE", "cuda"),
        local_rank=int(os.environ.get("LOCAL_RANK", rank)),
        local_world_size=int(os.environ.get("LOCAL_WORLD_SIZE", n)),
        collective_timeout_s=float(
            os.environ.get("SMLTPU_COLLECTIVE_TIMEOUT_S", "300")))
    rdv_timeout = float(os.environ.get("SMLTPU_RENDEZVOUS_TIMEOUT_S", "0")
                        or 0)
    if rdv_timeout > 0:
        from .collectives import dispatch_watchdog
        dispatch_watchdog(initialize_cluster, cfg, op="rendezvous", axis="-",
                          timeout_s=rdv_timeout)
    else:
        initialize_cluster(cfg)
    heartbeat.beat(step=0)        # rendezvoused: step 0 is reachable

    mod_name, fn_name = os.environ["SMLTPU_TASK"].split(":", 1)
    fn = getattr(importlib.import_module(mod_name), fn_name)
    result = fn(json.loads(os.environ.get("SMLTPU_TASK_ARGS", "null")))
    # the final telemetry batch flushes BEFORE the result marker: a clean
    # exit drops no spans or metrics
    if tm_emitter is not None:
        tm_emitter.stop()
        tm_emitter.emit_now(final=True)
    # under the wire lock: a heartbeat cannot land inside the result line
    gangplane.write_wire_line("SMLMP_RESULT:" + json.dumps(result))
    # keep beating through the shutdown: a rank finishing cleanly must
    # not be declared hung in its last second
    shutdown_cluster()
    if emitter is not None:
        emitter.stop()
    if flight_dump is not None:
        flight_dump()
    return 0


if __name__ == "__main__":
    sys.exit(main())
