"""Deterministic partition → rank placement.

The PyTorch port of the JAX package's ``parallel/placement.py``.  The
reference maps Spark partitions onto LightGBM ranks in a deterministic
order (machines sorted by host and smallest partition id, the executor
→ partition map broadcast by the coordinating process).  Here the same
contract maps Dataset partitions onto the ranks of a process group:
partition ids go to ranks in CONTIGUOUS BLOCKS (Spark's executor →
partition grouping), or round-robin on request.  The same core,
:func:`partition_assignment`, carves gang ranks into intra-host blocks
for the collective planner's hierarchical route, so placement and
reduction grouping cannot drift apart.  Pure Python: no torch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from .mesh import DATA_AXIS

#: accepted :func:`place_partitions` strategies
PLACEMENT_STRATEGIES = ("block", "round_robin")


@dataclasses.dataclass(frozen=True)
class PlacementMap:
    """partition id → data-axis rank; the machine-list analogue."""
    partition_to_rank: Dict[int, int]
    rank_to_partitions: Dict[int, List[int]]
    num_ranks: int

    def partitions_for_rank(self, rank: int) -> List[int]:
        return self.rank_to_partitions.get(rank, [])


def partition_assignment(num_partitions: int, num_ranks: int,
                         strategy: str = "block") -> PlacementMap:
    """``"block"``: rank r gets the contiguous run ``[r*k, (r+1)*k)``
    with the remainder spread over the first ranks.  ``"round_robin"``:
    partition p goes to rank ``p % num_ranks``.  Both are stable across
    runs for a given ``(num_partitions, num_ranks)``."""
    if strategy not in PLACEMENT_STRATEGIES:
        raise ValueError(f"strategy={strategy!r}: must be one of "
                         f"{PLACEMENT_STRATEGIES}")
    num_ranks = int(num_ranks)
    p2r: Dict[int, int] = {}
    r2p: Dict[int, List[int]] = {r: [] for r in range(num_ranks)}
    if strategy == "round_robin":
        for pid in range(num_partitions):
            r = pid % num_ranks
            p2r[pid] = r
            r2p[r].append(pid)
    else:
        base, rem = divmod(num_partitions, num_ranks)
        pid = 0
        for r in range(num_ranks):
            for _ in range(base + (1 if r < rem else 0)):
                p2r[pid] = r
                r2p[r].append(pid)
                pid += 1
    return PlacementMap(p2r, r2p, num_ranks)


def place_partitions(num_partitions: int, mesh, axis: str = DATA_AXIS,
                     strategy: str = "block") -> PlacementMap:
    """Assign partitions to the ranks of ``mesh``'s ``axis`` (a
    :class:`~.mesh.ProcessMesh`).  ``"block"`` is the layout
    :func:`rows_for_rank` relies on to return one contiguous row range."""
    return partition_assignment(num_partitions, mesh.axis_size(axis),
                                strategy)


def rows_for_rank(ds, placement: PlacementMap, rank: int) -> Tuple[int, int]:
    """Row range [start, end) owned by a data-axis rank, following the
    contiguous partition blocks (a ``"block"`` placement: round-robin
    ranks own non-contiguous partitions, which one range cannot
    describe)."""
    parts = placement.partitions_for_rank(rank)
    bounds = ds.partition_bounds()
    if not parts:
        return (0, 0)
    if parts != list(range(parts[0], parts[-1] + 1)):
        raise ValueError(
            f"rank {rank} owns non-contiguous partitions {parts} "
            "(round_robin placement?) — rows_for_rank needs block "
            "placement")
    return (bounds[parts[0]][0], bounds[parts[-1]][1])
