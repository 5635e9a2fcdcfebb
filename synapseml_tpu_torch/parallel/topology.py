"""Cluster topology discovery — the ``ClusterUtil`` analogue.

The PyTorch port of the JAX package's ``parallel/topology.py``.  The
reference discovers Spark executors and tasks per executor; the JAX
package reads the process/device table.  Here every rank contributes its
host name and its device kind (``torch.cuda.get_device_name`` or
``"cpu"``) through one ``all_gather_object``, and the hosts are the
distinct host names, each with its ranks in rank order.  The
reference's per-device mesh coordinates and slice indices have no
counterpart: no backend here exposes an interconnect layout, so the
planner treats the link structure as unknown, as the reference does on
the CPU.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Dict, List, Optional

import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class HostInfo:
    """One host: its name and the ranks (one device each) on it."""
    hostname: str
    ranks: List[int]
    device_kinds: List[str]

    @property
    def num_devices(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Snapshot of the gang: one device per rank, ranks grouped by host."""
    num_processes: int
    process_index: int
    num_devices: int
    num_local_devices: int
    platform: str                       # "gpu" | "cpu"
    hosts: List[HostInfo]
    device_kinds: List[str] = dataclasses.field(default_factory=list)

    def devices_per_host(self) -> int:
        return self.num_devices // max(1, len(self.hosts))


def _device_kind(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")


def get_topology(device: DeviceLike = "cuda") -> Topology:
    """Discover hosts and devices (``ClusterUtil.getExecutors``).  With
    an initialized process group this is collective: every rank must
    call it."""
    import torch.distributed as dist
    from .distributed import cluster_device
    if device == "cuda" and cluster_device() is not None:
        device = cluster_device()
    dev = resolve_device(device)
    mine = (socket.gethostname(), _device_kind(dev))
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        table: List = [None] * world
        dist.all_gather_object(table, mine)
    else:
        world, rank, table = 1, 0, [mine]
    by_host: Dict[str, List[int]] = {}
    for r, (host, _) in enumerate(table):
        by_host.setdefault(host, []).append(r)
    hosts = [HostInfo(h, rs, [table[r][1] for r in rs])
             for h, rs in sorted(by_host.items(), key=lambda kv: kv[1][0])]
    return Topology(
        num_processes=world, process_index=rank, num_devices=world,
        num_local_devices=len(by_host[mine[0]]),
        platform="gpu" if dev.type == "cuda" else "cpu", hosts=hosts,
        device_kinds=[k for _, k in table])


def get_num_rows_per_partition(ds, num_partitions: Optional[int] = None
                               ) -> List[int]:
    """Per-partition row counts (``ClusterUtil.getNumRowsPerPartition``:
    there a Spark job, here arithmetic)."""
    if num_partitions is not None:
        ds = ds.repartition(num_partitions)
    return [b - a for a, b in ds.partition_bounds()]
