"""Wrappers of kernels B1 (fused L2 nearest neighbour) and B3 (the fused
E-step plus M-step partials) — ``csrc/fused_l2nn.cu``.

Replace ``raft_tpu/kernels/fused_l2nn.py`` ``fused_l2_nn_pallas`` and
``fused_l2_nn_partials``.  A tensor on the CPU runs the plain PyTorch
version (``raft_tpu_torch.distance.fused_l2_nn``); a CUDA tensor launches
the kernel or raises — there is no quiet fallback.

B3 forms its M-step partials without atomics and without ordering the rows
by label: each block sums its fixed chunk of rows into its own partials
and a second launch adds the chunks in chunk order, so the sums repeat bit
for bit from run to run.  Rows of at most ``EM_MAX_D`` features with at
most ``EM_MAX_K`` centres (the IVF-PQ codebooks) take the fused narrow-row
kernel, which runs E and M in one launch for any number of subspaces
(:func:`fused_l2_nn_partials_batched`, the batch dimension of the JAX
package's ``jax.vmap``); wider rows take B1's E-step and then the
column-slab partials kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance import fused_l2_nn as plain
from raft_tpu_torch.distance.pairwise import _row_norms
from raft_tpu_torch.kernels import native

#: feature widths the TPU kernel accepts (``_MAX_D``); kept as the same
#: support predicate here
MAX_D = 2048
#: the narrow-row kernel's limits (``EM_MAX_D`` / ``EM_MAX_K`` in the source)
EM_MAX_D = 16
EM_MAX_K = 256


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1],
            "fused_l2_nn: x (m, d) and y (k, d) must share d")
    expects(x.shape[1] <= MAX_D, f"fused_l2_nn: d={x.shape[1]} > {MAX_D}")
    expects(x.device == y.device, "fused_l2_nn: x and y on one device")
    expects(y.shape[0] >= 1, "fused_l2_nn: y needs at least one row")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Float32, contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_nn(x: torch.Tensor, y: torch.Tensor, bf16_dot: bool):
    lib = native.library("fused_l2nn")
    m, d = x.shape
    k = y.shape[0]
    xn = _row_norms(x)
    yn = _row_norms(y)
    val = torch.empty(m, dtype=torch.float32, device=x.device)
    idx = torch.empty(m, dtype=torch.int32, device=x.device)
    err = lib.raft_fused_l2nn(x.data_ptr(), xn.data_ptr(), y.data_ptr(),
                              yn.data_ptr(), val.data_ptr(), idx.data_ptr(),
                              m, k, d, int(bool(bf16_dot)),
                              native.stream_handle(x.device))
    native.check(lib, err, "fused_l2nn_kernel")
    return val, idx


def fused_l2_nn(x: torch.Tensor, y: torch.Tensor, bf16_dot: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of x: (squared L2 distance to the nearest row of y, its
    index) as (val (m,) f32, idx (m,) int32); lowest index wins ties."""
    _check(x, y)
    if x.device.type == "cpu":
        return plain.fused_l2_nn_plain(x, y, bf16_dot)
    expects(x.device.type == "cuda", f"fused_l2_nn: device {x.device}")
    x = x.float().contiguous()
    y = y.float().contiguous()
    out = _launch_nn(x, y, bf16_dot)
    native.LAUNCHES["fused_l2_nn"] += 1
    return out


def _narrow(d: int, k: int, bf16_dot: bool) -> bool:
    return d <= EM_MAX_D and k <= EM_MAX_K and not bf16_dot


def _launch_em_small(x: torch.Tensor, y: torch.Tensor,
                     w: Optional[torch.Tensor]):
    """The narrow-row kernel over x (S, n, ds), y (S, k, ds); w (S, n) or
    (n,) shared by the subspaces, or None."""
    lib = native.library("fused_l2nn")
    s, n, ds = x.shape
    k = y.shape[1]
    dev = x.device
    val = torch.empty((s, n), dtype=torch.float32, device=dev)
    idx = torch.empty((s, n), dtype=torch.int32, device=dev)
    sums = torch.empty((s, k, ds), dtype=torch.float32, device=dev)
    wsum = torch.empty((s, k), dtype=torch.float32, device=dev)
    inertia = torch.empty(s, dtype=torch.float32, device=dev)
    part = torch.empty(int(lib.raft_em_small_scratch(s, n, k, ds)),
                       dtype=torch.float32, device=dev)
    w_stride = 0 if w is None or w.ndim == 1 else n
    err = lib.raft_em_small(x.data_ptr(), 0 if w is None else w.data_ptr(),
                            w_stride, y.data_ptr(), s, n, k, ds,
                            val.data_ptr(), idx.data_ptr(), part.data_ptr(),
                            sums.data_ptr(), wsum.data_ptr(),
                            inertia.data_ptr(), native.stream_handle(dev))
    native.check(lib, err, "em_small_kernel")
    return val, idx, sums, wsum, inertia


def _launch_cluster_partials(x: torch.Tensor, idx: torch.Tensor,
                             w: Optional[torch.Tensor], k: int):
    lib = native.library("fused_l2nn")
    m, d = x.shape
    dev = x.device
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    wsum = torch.empty(k, dtype=torch.float32, device=dev)
    part = torch.empty(int(lib.raft_cluster_partials_scratch(m, k, d)),
                       dtype=torch.float32, device=dev)
    err = lib.raft_cluster_partials(x.data_ptr(),
                                    0 if w is None else w.data_ptr(),
                                    idx.data_ptr(), m, k, d, part.data_ptr(),
                                    sums.data_ptr(), wsum.data_ptr(),
                                    native.stream_handle(dev))
    native.check(lib, err, "cluster_partials_kernel")
    return sums, wsum


def _weights(weights: Optional[torch.Tensor], shapes, x: torch.Tensor):
    if weights is None:
        return None
    w = _aligned(weights)
    expects(tuple(w.shape) in shapes and w.device == x.device,
            f"weights must be one of {sorted(shapes)} on x's device")
    return w


def fused_l2_nn_partials(x: torch.Tensor, y: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         bf16_dot: bool = False):
    """E-step plus M-step partials: ``(val (m,), idx (m,) int32,
    sums (k, d), wsum (k,), inertia ())`` with Σ over each cluster's
    members of w·x and w (``weights`` default to ones) and inertia
    Σ w·val."""
    _check(x, y)
    if x.device.type == "cpu":
        return plain.fused_l2_nn_partials_plain(x, y, weights, bf16_dot)
    expects(x.device.type == "cuda",
            f"fused_l2_nn_partials: device {x.device}")
    m, d = x.shape
    k = y.shape[0]
    x = _aligned(x)
    y = _aligned(y)
    w = _weights(weights, {(m,)}, x)
    if _narrow(d, k, bf16_dot):
        val, idx, sums, wsum, inertia = _launch_em_small(x[None], y[None], w)
        out = val[0], idx[0], sums[0], wsum[0], inertia[0]
    else:
        val, idx = _launch_nn(x, y, bf16_dot)
        sums, wsum = _launch_cluster_partials(x, idx, w, k)
        inertia = torch.sum(val) if w is None else torch.sum(val * w)
        out = val, idx, sums, wsum, inertia
    native.LAUNCHES["fused_l2_nn_partials"] += 1
    return out


def fused_l2_nn_partials_batched(x: torch.Tensor, y: torch.Tensor,
                                 weights: Optional[torch.Tensor] = None):
    """:func:`fused_l2_nn_partials` for S independent problems at once
    (the PER_SUBSPACE codebooks): x (S, n, ds), y (S, k, ds), weights (n,)
    shared by all or (S, n).  Returns ``(val (S, n), idx (S, n) int32,
    sums (S, k, ds), wsum (S, k), inertia (S,))``.  Narrow rows run every
    subspace in one launch, with the bits of S launches of one subspace;
    wider rows run :func:`fused_l2_nn_partials` per subspace."""
    expects(x.ndim == 3 and y.ndim == 3 and x.shape[0] == y.shape[0]
            and x.shape[2] == y.shape[2],
            "fused_l2_nn_partials_batched: x (S, n, d), y (S, k, d)")
    expects(x.device == y.device and x.shape[0] >= 1 and y.shape[1] >= 1,
            "fused_l2_nn_partials_batched: S >= 1 and k >= 1, on one device")
    if x.device.type == "cpu":
        return plain.fused_l2_nn_partials_batched_plain(x, y, weights)
    expects(x.device.type == "cuda",
            f"fused_l2_nn_partials_batched: device {x.device}")
    s, n, d = x.shape
    k = y.shape[1]
    if not _narrow(d, k, False):
        outs = [fused_l2_nn_partials(
            x[i], y[i], None if weights is None
            else (weights if weights.ndim == 1 else weights[i]))
            for i in range(s)]
        return tuple(torch.stack(t) for t in zip(*outs))
    x = _aligned(x)
    y = _aligned(y)
    w = _weights(weights, {(n,), (s, n)}, x)
    out = _launch_em_small(x, y, w)
    native.LAUNCHES["fused_l2_nn_partials"] += 1
    return out
