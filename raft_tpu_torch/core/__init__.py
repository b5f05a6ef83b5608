from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import (CudaError, DeviceError, LogicError,
                                      RaftError, expects, fail)
from raft_tpu_torch.core.handle import Handle, Stream, resolve_device
from raft_tpu_torch.core.kvp import KeyValuePair, kvp_min

__all__ = ["bucket_dim", "CudaError", "DeviceError", "KeyValuePair",
           "LogicError", "RaftError", "expects", "fail", "Handle", "Stream",
           "kvp_min", "resolve_device"]
