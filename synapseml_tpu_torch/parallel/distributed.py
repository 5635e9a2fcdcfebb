"""Rendezvous: ``torch.distributed`` process groups through a TCPStore.

The PyTorch port of the JAX package's ``parallel/distributed.py``.  The
reference rendezvouses workers through a socket handshake with Spark's
coordinating process and retries ``LGBM_NetworkInit`` with exponential
backoff; the JAX package calls ``jax.distributed.initialize``.  Here rank 0 serves a
``TCPStore`` at the coordinator address the launcher reserved, every
rank joins it, and ``init_process_group`` forms the group with an
explicit ``timeout`` over that store.

The backend is chosen explicitly and never by fallback:

- ``gloo`` for ``device="cpu"`` (the default there);
- ``nccl`` where each rank has its own card (the default for
  ``device="cuda"``): the rank binds ``cuda:LOCAL_RANK``.  Asking for
  nccl with more ranks on this host than cards raises BEFORE the
  rendezvous: NCCL refuses two ranks on one device ("Duplicate GPU
  detected"), and no backend is switched quietly;
- ``gloo`` over CUDA tensors only when the caller passed
  ``backend="gloo"`` with ``device="cuda"`` (several ranks sharing one
  card): the rank binds ``cuda:LOCAL_RANK % cards``, and the
  point-to-point sends gloo refuses on CUDA tensors stage through pinned
  host memory (:attr:`~.mesh.ProcessMesh.stages_p2p`).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import time
from typing import Optional

import torch

logger = logging.getLogger("synapseml_tpu_torch")

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Rendezvous parameters (the machine-list analogue)."""
    coordinator_address: Optional[str] = None   # "host:port"
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    init_timeout_s: float = 300.0
    #: "gloo" | "nccl"; None: gloo on the CPU, nccl on a card
    backend: Optional[str] = None
    #: this rank's device kind: "cuda" (default) or "cpu"
    device: str = "cuda"
    #: this rank's index among the ranks of its host (default: its rank,
    #: the local launcher's layout)
    local_rank: Optional[int] = None
    #: ranks on this host (default: ``num_processes``)
    local_world_size: Optional[int] = None
    #: the process group's default collective timeout
    collective_timeout_s: float = 300.0


_state = {"initialized": False, "device": None, "rendezvous_s": None}


def resolve_backend(cfg: ClusterConfig) -> str:
    """The backend ``cfg`` asks for, checked against the device before
    any rendezvous (see the module docstring)."""
    dev = torch.device(cfg.device)
    backend = cfg.backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: must be one of {BACKENDS}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend='nccl' moves CUDA tensors; pass "
                             "device='cuda' or backend='gloo'")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local = int(cfg.local_world_size or cfg.num_processes or 1)
        if local > cards:
            raise RuntimeError(
                f"backend='nccl' with {local} ranks on this host and "
                f"{cards} CUDA device(s): NCCL refuses two ranks on one "
                "device ('Duplicate GPU detected'); pass backend='gloo' "
                "to share a card")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is "
                           "available; pass device='cpu'")
    return backend


def _rank_device(cfg: ClusterConfig) -> torch.device:
    dev = torch.device(cfg.device)
    if dev.type != "cuda":
        return torch.device("cpu")
    local = int(cfg.local_rank if cfg.local_rank is not None
                else (cfg.process_id or 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def rendezvous_seconds() -> Optional[float]:
    """Seconds the last :func:`initialize_cluster` took to form the
    group (None without one)."""
    return _state["rendezvous_s"]


def cluster_device() -> Optional[torch.device]:
    """The device :func:`initialize_cluster` bound this rank to (None
    before it, or for a CPU rank)."""
    return _state["device"]


def initialize_cluster(config: Optional[ClusterConfig] = None,
                       max_retries: int = 5,
                       base_delay_s: float = 1.0) -> None:
    """Join the cluster; idempotent.  A single process without a
    coordinator forms no group (the ``local[*]`` analogue); with a
    coordinator even one rank forms a real group.  The rendezvous
    retries with exponential backoff, like the reference's
    NetworkInit."""
    import torch.distributed as dist
    if _state["initialized"]:
        return
    cfg = config or ClusterConfig()
    if cfg.coordinator_address is None and cfg.num_processes in (None, 1):
        _state["initialized"] = True
        return
    backend = resolve_backend(cfg)
    dev = _rank_device(cfg)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, _, port = str(cfg.coordinator_address).rpartition(":")
    world, rank = int(cfg.num_processes), int(cfg.process_id)
    delay = base_delay_s
    last: Optional[BaseException] = None
    t0 = time.perf_counter()
    for attempt in range(max_retries):
        try:
            store = dist.TCPStore(
                host, int(port), world, rank == 0,
                timeout=datetime.timedelta(seconds=cfg.init_timeout_s))
            kw = {"device_id": dev} if backend == "nccl" else {}
            dist.init_process_group(
                backend, store=store, rank=rank, world_size=world,
                timeout=datetime.timedelta(
                    seconds=cfg.collective_timeout_s), **kw)
            _state.update(initialized=True,
                          device=dev if dev.type == "cuda" else None,
                          rendezvous_s=time.perf_counter() - t0)
            logger.info("joined cluster: rank %d/%d over %s", rank, world,
                        backend)
            return
        except (RuntimeError, ValueError, OSError) as e:
            last = e
            logger.warning("rendezvous attempt %d failed: %s", attempt, e)
            if dist.is_initialized():
                dist.destroy_process_group()
            time.sleep(delay)
            delay *= 2
    raise RuntimeError(f"cluster rendezvous failed after {max_retries} "
                       "attempts") from last


def shutdown_cluster() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _state.update(initialized=False, device=None, rendezvous_s=None)
