"""Batched query serving over the port's IVF-Flat, IVF-PQ and brute-force
backends (port of ``raft_tpu/serve``): :class:`ServeEngine` with request
coalescing, continuous batching (:class:`SchedulerConfig`,
:class:`CostModel`), deadline-aware admission (:class:`ServeRequest`,
:class:`AdmissionController`, :class:`RejectedError`) and supervised
dispatch (:class:`DispatchSupervisor`, :class:`WatchdogTimeout`,
:class:`DispatchError`) and the online autotuner (:class:`AutoTuner`,
:class:`TunerConfig`, :class:`Candidate`; ``AutoTuner(engine, ...).run()``
is the one-shot tune).  :class:`ReplicaRouter` comes with its module; no
backend of the port has replicas yet.
"""

from raft_tpu_torch.serve.admission import (  # noqa: F401
    AdmissionController,
    RejectedError,
    ServeRequest,
)
from raft_tpu_torch.serve.autotune import (  # noqa: F401
    AutoTuner,
    Candidate,
    TunerConfig,
)
from raft_tpu_torch.serve.engine import ServeEngine  # noqa: F401
from raft_tpu_torch.serve.schedule import (  # noqa: F401
    CostModel,
    ReplicaRouter,
    SchedulerConfig,
)
from raft_tpu_torch.serve.supervise import (  # noqa: F401
    DispatchError,
    DispatchSupervisor,
    WatchdogTimeout,
)

__all__ = ["ServeEngine", "ServeRequest", "AdmissionController",
           "RejectedError", "DispatchSupervisor", "DispatchError",
           "WatchdogTimeout", "SchedulerConfig", "CostModel",
           "ReplicaRouter", "AutoTuner", "TunerConfig", "Candidate"]
