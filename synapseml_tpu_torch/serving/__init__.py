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

The autoscaler, disaggregated prefill and the distributed router are
not ported yet (ROADMAP A5, A8).
"""

from .continuous import ContinuousClient
from .llm import LLMServer
from .qos import QosScheduler, TenantPolicy, jain_fairness
from .server import (ApiHandle, MultiPipelineServer, PipelineServer,
                     ServingReply, ServingRequest, ServingServer)

__all__ = ["ApiHandle", "ContinuousClient", "LLMServer",
           "MultiPipelineServer", "PipelineServer", "QosScheduler",
           "ServingReply", "ServingRequest", "ServingServer",
           "TenantPolicy", "jain_fairness"]
