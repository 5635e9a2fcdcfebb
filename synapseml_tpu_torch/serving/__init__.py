"""Model serving of the PyTorch port.

- :class:`PipelineServer` serves one fitted model (any stage of the
  port, on the device it was built for) over HTTP: requests → micro-
  batches → ``model.transform`` → replies, under the row guard's
  per-record isolation; :class:`MultiPipelineServer` serves several
  named models on one listener.  :class:`ContinuousClient`
  (``continuous.py``) is the framed-mode client of either.
- :class:`LLMServer` (``llm.py``) runs the port's ``SlotEngine`` behind
  a :class:`ServingServer` listener through the continuous-batching
  decode loop (``server.py``), with the multi-tenant QoS plane
  (``qos.py``).
- Replicated serving: :class:`DistributedServingServer` gathers every
  rank's listener into one routing table over the process mesh, and
  :class:`ReplicaRouter` routes over it around dead, draining, warming
  and breaker-open replicas with session affinity (``distributed.py``);
  :class:`PrefillPool` / :class:`PrefillWorker` take prefill off the
  decode replica (``disagg.py``); :class:`Autoscaler` grows and shrinks
  a :class:`ServingReplicaSet`, a :class:`SupervisorPool` or a prefill
  pool off ``/sloz`` under a :class:`CapacityArbiter` (``autoscaler.py``).
"""

from .autoscaler import (AutoscalePolicy, Autoscaler, CapacityArbiter,
                         ScaleDecision, ServingReplicaSet, SupervisorPool,
                         sloz_signals)
from .continuous import ContinuousClient
from .disagg import PrefillPool, PrefillWorker
from .distributed import (ROLE_NAMES, DistributedServingServer,
                          NoHealthyReplicaError, ReplicaRouter,
                          RouteResult, exchange_routing_table,
                          probe_replica)
from .llm import LLMServer
from .qos import QosScheduler, TenantPolicy, jain_fairness
from .server import (ApiHandle, MultiPipelineServer, PipelineServer,
                     ServingReply, ServingRequest, ServingServer)

__all__ = ["ApiHandle", "AutoscalePolicy", "Autoscaler", "CapacityArbiter",
           "ContinuousClient", "DistributedServingServer", "LLMServer",
           "MultiPipelineServer", "NoHealthyReplicaError", "PipelineServer",
           "PrefillPool", "PrefillWorker", "QosScheduler", "ROLE_NAMES",
           "ReplicaRouter", "RouteResult", "ScaleDecision",
           "ServingReplicaSet", "ServingReply", "ServingRequest",
           "ServingServer", "SupervisorPool", "TenantPolicy",
           "exchange_routing_table", "jain_fairness", "probe_replica",
           "sloz_signals"]
