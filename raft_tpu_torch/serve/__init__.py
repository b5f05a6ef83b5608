from raft_tpu_torch.serve.engine import ServeEngine

__all__ = ["ServeEngine"]
