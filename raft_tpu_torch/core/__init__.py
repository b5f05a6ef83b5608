from raft_tpu_torch.core import interruptible
from raft_tpu_torch.core.aot import (AotFunction, aot,
                                    aot_compile_counters,
                                    enable_persistent_cache,
                                    try_enable_persistent_cache)
from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import (CudaError, DeviceError,
                                      InterruptedError_, LogicError,
                                      RaftError, expects, fail)
from raft_tpu_torch.core.handle import (DeviceResources, Handle, Stream,
                                       auto_sync_handle, default_handle,
                                       resolve_device)
from raft_tpu_torch.core.kvp import KeyValuePair, kvp_min
from raft_tpu_torch.core.logger import (Logger, log_debug, log_error,
                                       log_info, log_trace, log_warn,
                                       time_range, traced)
from raft_tpu_torch.core.mdarray import (Layout, MdArray, MdSpan, MemoryType,
                                        as_device_array, col_major,
                                        make_device_matrix,
                                        make_device_mdarray,
                                        make_device_scalar,
                                        make_device_vector, make_host_matrix,
                                        make_host_scalar, make_host_vector,
                                        row_major)
from raft_tpu_torch.core.prewarm import prewarm

__all__ = ["AotFunction", "CudaError", "DeviceError", "DeviceResources",
           "Handle", "aot", "aot_compile_counters",
           "enable_persistent_cache", "prewarm",
           "try_enable_persistent_cache",
           "InterruptedError_", "KeyValuePair", "Layout", "Logger",
           "LogicError", "MdArray", "MdSpan", "MemoryType", "RaftError",
           "Stream", "as_device_array", "auto_sync_handle", "bucket_dim",
           "col_major", "default_handle", "expects", "fail", "interruptible",
           "kvp_min", "log_debug", "log_error", "log_info", "log_trace",
           "log_warn", "make_device_matrix", "make_device_mdarray",
           "make_device_scalar", "make_device_vector", "make_host_matrix",
           "make_host_scalar", "make_host_vector", "resolve_device",
           "row_major", "time_range", "traced"]
