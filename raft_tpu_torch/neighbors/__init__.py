from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

__all__ = ["ivf_flat", "ivf_pq"]
