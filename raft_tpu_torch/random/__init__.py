from raft_tpu_torch.random.rng import RngState, sample_without_replacement

__all__ = ["RngState", "sample_without_replacement"]
