"""The parallel layer of the PyTorch port over ``torch.distributed``.

The PyTorch port of the JAX package's ``parallel/``.  The mapping:

- **One process per rank, one device per rank.**  A JAX ``Mesh`` over
  local devices becomes a process group; :class:`ProcessMesh` gives the
  world size, this rank and named axis sizes (``DATA_AXIS``,
  ``MODEL_AXIS``, ...), each axis below the whole world a set of
  ``dist.new_group`` sub-groups.  Collectives are plain functions on this
  rank's tensor that take the mesh and an axis name where the JAX code
  names an axis inside ``shard_map``.
- **Backends are chosen explicitly, never by fallback**
  (:func:`initialize_cluster`): gloo for ``device="cpu"``; nccl where
  each rank has its own card (``cuda:LOCAL_RANK``); gloo over CUDA
  tensors only when the caller passes ``backend="gloo"`` (several ranks
  sharing one card).  nccl with more ranks than cards raises before the
  rendezvous.  On gloo over CUDA tensors the point-to-point ops stage
  through pinned host memory and count their bytes
  (``ProcessMesh.staged_bytes``); the other collectives run on the device
  tensors.
- **Rendezvous** through a ``TCPStore`` at the coordinator address the
  launcher reserves (:class:`ReservedPort`).

Every entry point takes ``device`` (default ``"cuda"``, a
``RuntimeError`` without a card unless the caller passed
``device="cpu"``).  The supervisor resumes a relaunched gang from its
checkpoint directory and resizes it (``min_ranks``, ``resize``,
``capacity_fn``); :mod:`.compilecache` shares the kernel builds across
relaunches.  ``serving.distributed`` gathers the serving routing table
over a ``ProcessMesh``.  DL training runs over a data mesh, the
``(data, expert)`` mesh of :func:`~.mesh.dp_ep_mesh` or the ``(data,
model)`` mesh of :func:`~.mesh.dp_tp_mesh` (``models.dl.training``);
:func:`~.mesh.dp_sp_tp_mesh` adds a ``seq`` axis for ring attention
(``models.dl.ring_attention``), and :mod:`.pipeline` runs the GPipe
schedule over a ``pipe`` axis.  ``ppermute`` / ``ring_shift`` are
differentiable (the gradient goes back along the inverse permutation).
"""

from .collectives import (CollectiveTimeout, all_gather, all_to_all,
                          allreduce_fn, axis_index, barrier,
                          dispatch_watchdog, hierarchical_psum, pmax, pmean,
                          pmin, ppermute, psum, reduce_scatter,
                          ring_allreduce, ring_shift, tree_psum_bucketed)
from .compression import (CollectiveConfig, compressed_psum,
                          compressed_tree_sync, resolve_collective_config)
from .distributed import (ClusterConfig, initialize_cluster,
                          shutdown_cluster)
from .launcher import (GangInterrupted, ReservedPort, WorkerFailure,
                       find_free_port, run_on_local_cluster)
from .mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
                   ProcessMesh, data_parallel_mesh, dp_ep_mesh,
                   dp_sp_tp_mesh, dp_tp_mesh, pad_to_multiple, shard_batch)
from .pipeline import (local_stage, pipeline_apply, pipeline_loss,
                       stack_stage_params)
from .placement import (PlacementMap, partition_assignment,
                        place_partitions, rows_for_rank)
from .planner import (CollectivePlanner, ReductionPlan, TopologySpec,
                      get_planner, planned_psum, set_planner)
from .selfcheck import cluster_report
from .supervisor import GangSupervisor, HeartbeatMonitor
from .topology import Topology, get_num_rows_per_partition, get_topology
