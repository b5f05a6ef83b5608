from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import (CudaError, DeviceError, LogicError,
                                      RaftError, expects, fail)
from raft_tpu_torch.core.handle import Handle, Stream, resolve_device

__all__ = ["bucket_dim", "CudaError", "DeviceError", "LogicError",
           "RaftError", "expects", "fail", "Handle", "Stream",
           "resolve_device"]
