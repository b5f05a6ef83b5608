"""raft_tpu_torch — the PyTorch/CUDA port of raft_tpu.

The package mirrors ``raft_tpu``'s layout module for module.  Plain tensor
code is PyTorch; every Pallas kernel of the JAX package on the ported path
is a CUDA kernel written by hand for Hopper (``kernels/csrc``), built with
``nvcc`` at first use and bound through ``ctypes``.

Entry points run on the card (``device=None`` means ``cuda``) and raise
when no card is present; pass ``device="cpu"`` to run the plain PyTorch
versions on the host.  The package imports neither ``jax`` nor anything of
``raft_tpu``.
"""

__version__ = "0.1.0"
