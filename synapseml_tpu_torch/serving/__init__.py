"""Model serving of the PyTorch port: the LLM served over HTTP.

:class:`LLMServer` (``llm.py``) runs the port's ``SlotEngine`` behind a
:class:`ServingServer` listener through the continuous-batching decode
loop (``server.py``), with the multi-tenant QoS plane (``qos.py``).  The
pipeline servers, the autoscaler, disaggregated prefill and the
distributed router are not ported yet (ROADMAP A6, A8).
"""

from .llm import LLMServer
from .qos import QosScheduler, TenantPolicy, jain_fairness
from .server import ApiHandle, ServingReply, ServingRequest, ServingServer

__all__ = ["ApiHandle", "LLMServer", "QosScheduler", "ServingReply",
           "ServingRequest", "ServingServer", "TenantPolicy",
           "jain_fairness"]
