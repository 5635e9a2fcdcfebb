"""Cluster bring-up self-check — prove the rendezvous works.

The PyTorch port of the JAX package's ``parallel/selfcheck.py``.  The
reference validates its ring at bring-up (``LGBM_NetworkInit`` fails
loudly when a peer is unreachable).  :func:`cluster_report` runs on
every rank of a freshly formed group and returns facts that only come
out right when the rendezvous is real: the device table (each rank's
device, one per rank), a partition placement computed independently on
each rank, a ``psum`` whose value needs every rank's contribution and an
``all_gather`` whose order proves the ranks agree on one global order.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .mesh import DATA_AXIS, data_parallel_mesh


def cluster_report(args: Any = None) -> Dict[str, Any]:
    """Rendezvous evidence from this rank (JSON-serializable).
    ``args``: ``n_partitions`` (default 12) and ``device`` (default
    ``"cuda"``, the rank's bound card)."""
    args = args or {}
    n_partitions = int(args.get("n_partitions", 12))
    mesh = data_parallel_mesh(device=args.get("device", "cuda"))
    from .collectives import all_gather, psum
    from .placement import place_partitions
    from .topology import get_topology

    topo = get_topology(mesh.device)
    table = [[r, kind] for r, kind in enumerate(topo.device_kinds)]
    pm = place_partitions(n_partitions, mesh)
    placement = {str(p): r for p, r in sorted(pm.partition_to_rank.items())}
    n = mesh.axis_size(DATA_AXIS)
    me = torch.tensor([float(mesh.axis_index(DATA_AXIS))],
                      device=mesh.device)
    summed = psum(me, mesh)
    gathered = all_gather(me, mesh, tiled=True)
    return {
        "process_index": mesh.rank,
        "process_count": mesh.world_size,
        "global_devices": topo.num_devices,
        "local_devices": topo.num_local_devices,
        "backend": mesh.backend,
        "device": str(mesh.device),
        "device_table": table,
        "hosts": [h.hostname for h in topo.hosts],
        "placement": placement,
        "psum_local": [float(v) for v in summed.cpu()],
        "psum_expected": float(sum(range(n))),
        "all_gather": [float(v) for v in gathered.cpu()],
    }
