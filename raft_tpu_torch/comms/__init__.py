"""Communicator layer over ``torch.distributed`` (port of
``raft_tpu/comms``; reference raft/comms/ + raft/core/comms.hpp, session
bootstrap raft-dask — SURVEY.md §2.13, §2.16).  One process per rank,
each rank one device: NCCL on the card, gloo on the CPU."""

from raft_tpu_torch.comms.comms_types import (  # noqa: F401
    ReduceOp,
    Request,
    Status,
)
from raft_tpu_torch.comms.comms import (  # noqa: F401
    Comms,
    ReplicaLayout,
    as_comms,
    build_comms,
)
from raft_tpu_torch.comms.session import (  # noqa: F401
    CommsSession,
    get_comms_state,
    local_handle,
)
from raft_tpu_torch.comms import self_tests  # noqa: F401
