from raft_tpu_torch.neighbors import ivf_flat

__all__ = ["ivf_flat"]
