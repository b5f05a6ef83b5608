"""Label utilities (port of ``raft_tpu/label``; reference raft/label/)."""

from raft_tpu_torch.label.classlabels import (get_ovr_labels,
                                              get_unique_labels,
                                              make_monotonic)
from raft_tpu_torch.label.merge_labels import merge_labels

__all__ = ["get_ovr_labels", "get_unique_labels", "make_monotonic",
           "merge_labels"]
