"""serving/ — the LLM-serving workload on the port: continuous batching
over an eager PyTorch decode loop, with the KV cache's blocks living on
the CUDA device plane and every client a streaming RPC.

* :mod:`kv_cache` and :mod:`scheduler` — copies of the reference's
  device-agnostic modules, imports re-pointed at the port.
* :mod:`engine` — the front-end, rewritten on torch; over a mesh one
  engine a rank, the leader's device operations replayed by the
  followers through :mod:`lockstep`.
"""

from brpc_tpu_torch.serving.engine import ServingEngine  # noqa: F401
from brpc_tpu_torch.serving.kv_cache import KvBlockPlane  # noqa: F401
from brpc_tpu_torch.serving.lockstep import Lockstep  # noqa: F401
from brpc_tpu_torch.serving.scheduler import Scheduler, Sequence  # noqa: F401
