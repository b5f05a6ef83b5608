"""Fused L2 nearest neighbour — the plain PyTorch versions of kernels B1
and B3 (``raft_tpu/kernels/fused_l2nn.py``).

These are the contract the CUDA kernels in ``kernels/csrc/fused_l2nn.cu``
are held to, and what the kernel wrappers run for tensors on the CPU:

* :func:`fused_l2_nn_plain` — per row of x, the squared L2 distance
  ``max(||x||² + ||y||² − 2 x·y, 0)`` to its nearest row of y and that
  row's index; the lowest index wins exact ties (``torch.argmin`` returns
  the first minimum, as ``jnp.argmin`` does).
* :func:`fused_l2_nn_partials_plain` — the same E-step plus the M-step
  partials: (k, d) Σ w·x per cluster, (k,) Σ w, and the inertia Σ w·val.
* :func:`fused_l2_nn_partials_batched_plain` — that for S independent
  problems (the PER_SUBSPACE codebooks), one at a time, so it never holds
  an (S, n, k) distance tensor.

Beside them the public surface of ``raft_tpu/distance/fused_l2_nn.py``:
:func:`fused_l2_nn` (a :class:`KeyValuePair` per row, through kernel B1 on
the card), :func:`fused_l2_nn_min_reduce`, :func:`fused_l2_nn_argmin`, and
the JAX scan's tile hooks :func:`l2_nn_blocks` / :func:`l2_nn_tile` as
plain functions with the same contracts (on the card B1 does their work).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.aot import aot
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import auto_sync_handle
from raft_tpu_torch.core.kvp import KeyValuePair, kvp_min
from raft_tpu_torch.distance.pairwise import _row_norms, as_input
from raft_tpu_torch.linalg.reduce import segment_sum

#: rows per distance block: bounds the (rows, k) transient of the plain
#: version (256 MB at k = 1024)
_BLOCK_ROWS = 1 << 16


def fused_l2_nn_plain(x: torch.Tensor, y: torch.Tensor,
                      bf16_dot: bool = False,
                      x_norms: Optional[torch.Tensor] = None,
                      y_norms: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(val (m,) f32, idx (m,) int32) of the nearest row of *y*.

    ``bf16_dot`` rounds both operands of the dot product to bfloat16 (the
    products are then exact in float32 and summed in float32) while the
    norms stay float32 — the ``precision="default"`` opt-in of the TPU
    kernel.  Squared row norms may be given precomputed."""
    x = x.float()
    y = y.float()
    xn = _row_norms(x) if x_norms is None else x_norms.float()
    yn = _row_norms(y) if y_norms is None else y_norms.float()
    xd, yd = ((x.bfloat16().float(), y.bfloat16().float()) if bf16_dot
              else (x, y))
    m = x.shape[0]
    val = torch.empty(m, dtype=torch.float32, device=x.device)
    idx = torch.empty(m, dtype=torch.int32, device=x.device)
    for r0 in range(0, m, _BLOCK_ROWS):
        r1 = min(m, r0 + _BLOCK_ROWS)
        d = torch.clamp_min(xn[r0:r1, None] + yn[None, :]
                            - 2.0 * (xd[r0:r1] @ yd.T), 0.0)
        i = torch.argmin(d, dim=1)
        val[r0:r1] = torch.gather(d, 1, i[:, None])[:, 0]
        idx[r0:r1] = i.to(torch.int32)
    return val, idx


def cluster_partials_plain(x: torch.Tensor, labels: torch.Tensor, k: int,
                           weights: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The M-step partials from given labels: ((k, d) Σ w·x, (k,) Σ w)."""
    x = x.float()
    if weights is None:
        w = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
        sums = segment_sum(x, labels, k)
    else:
        w = weights.float()
        sums = segment_sum(x * w[:, None], labels, k)
    return sums, segment_sum(w, labels, k)


def fused_l2_nn_partials_plain(x: torch.Tensor, y: torch.Tensor,
                               weights: Optional[torch.Tensor] = None,
                               bf16_dot: bool = False):
    """(val, idx, sums (k, d), wsum (k,), inertia ()) — see module doc."""
    val, idx = fused_l2_nn_plain(x, y, bf16_dot)
    sums, wsum = cluster_partials_plain(x, idx, y.shape[0], weights)
    w = None if weights is None else weights.float()
    inertia = torch.sum(val) if w is None else torch.sum(val * w)
    return val, idx, sums, wsum, inertia


def fused_l2_nn_partials_batched_plain(x: torch.Tensor, y: torch.Tensor,
                                       weights: Optional[torch.Tensor] = None):
    """x (S, n, d), y (S, k, d), weights (n,) or (S, n) → (val (S, n),
    idx (S, n), sums (S, k, d), wsum (S, k), inertia (S,))."""
    outs = [fused_l2_nn_partials_plain(
        x[i], y[i], None if weights is None
        else (weights if weights.ndim == 1 else weights[i]))
        for i in range(x.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))


# ---------------------------------------------------------------------------
# the public surface (raft_tpu/distance/fused_l2_nn.py :110-230)
# ---------------------------------------------------------------------------

def l2_nn_blocks(y: torch.Tensor, y_norms: torch.Tensor, block_n: int,
                 align: int = 1):
    """Pre-block y for :func:`l2_nn_tile`: the row count padded to a whole
    number of (``align``-rounded) blocks, padded rows with +inf norms so
    they never win.  Returns (y_blocks (nb, bn, d), yn_blocks (nb, bn),
    bases (nb,) int32)."""
    n, d = y.shape
    bn = min(block_n, n)
    bn = -(-bn // align) * align
    nb = -(-n // bn)
    pad = nb * bn - n
    y_p = torch.cat([y, y.new_zeros((pad, d))]) if pad else y
    yn_p = (torch.cat([y_norms, y_norms.new_full((pad,), float("inf"))])
            if pad else y_norms)
    bases = torch.arange(nb, dtype=torch.int32, device=y.device) * bn
    return y_p.reshape(nb, bn, d), yn_p.reshape(nb, bn), bases


def l2_nn_tile(xb: torch.Tensor, y_blocks: torch.Tensor,
               yn_blocks: torch.Tensor, bases: torch.Tensor,
               precision: str = "highest",
               xn: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest y-row (squared L2 value, int32 index) of every row of one
    tile *xb* against :func:`l2_nn_blocks` output.  Blocks are ranked on
    ``||y||² − 2 x·y`` and ``||x||²`` is added to the winner only (it
    cannot change the argmin); the result is clamped at 0.  Ties go to the
    lower index within and across blocks.  ``precision="default"`` takes
    the bfloat16 dot products of :func:`fused_l2_nn_plain`."""
    xf = xb.float()
    if xn is None:
        xn = _row_norms(xf)
    best = None
    for yb, ynb, base in zip(y_blocks, yn_blocks, bases):
        yf = yb.float()
        if precision == "default":
            t = ynb[None, :] - 2.0 * (xf.bfloat16().float()
                                      @ yf.bfloat16().float().T)
        else:
            t = ynb[None, :] - 2.0 * (xf @ yf.T)
        val, arg = torch.min(t, dim=1)
        kv = KeyValuePair(key=base + arg.to(torch.int32), value=val)
        best = kv if best is None else kvp_min(best, kv)
    return torch.clamp_min(xn + best.value, 0.0), best.key


def fused_l2_nn(x, y, sqrt: bool = False, x_norms=None, y_norms=None,
                precision: str = "highest", *, device=None,
                engine: Optional[str] = None) -> KeyValuePair:
    """For each row of x, its nearest row of y by squared L2 (by L2 with
    *sqrt*) as ``KeyValuePair(key=index int32, value=distance f32)``
    (reference ``fusedL2NN``, fused_l2_nn.cuh:89).  On the card this is
    kernel B1 (``engine="cuda"``, the default there); *sqrt* is applied to
    its clamped minimum.  Given norms are used by the plain path; B1 forms
    the same norms from the rows itself.  ``precision="default"`` rounds
    the dot products' operands to bfloat16 (B1's ``bf16_dot``).  Arrays go
    to *device* (``None``: the card); tensors stay where they are."""
    x, y = as_input(x, device), as_input(y, device)
    expects(x.shape[1] == y.shape[1], "x and y must share feature dim")
    val, idx = _fused_l2_nn_aot(x, y, bool(sqrt), x_norms, y_norms,
                                precision, engine)
    return KeyValuePair(key=idx, value=val)


def _fused_l2_nn_impl(x: torch.Tensor, y: torch.Tensor, sqrt: bool,
                      x_norms, y_norms, precision: str,
                      engine: Optional[str]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_l2_nn`'s program: (distances, indices)."""
    from raft_tpu_torch.kernels.engine import resolve_engine

    bf16 = precision == "default"
    if resolve_engine("l2nn", x.device, engine=engine) == "cuda":
        from raft_tpu_torch.kernels.fused_l2nn import fused_l2_nn as b1

        val, idx = b1(x, y, bf16)
    else:
        val, idx = fused_l2_nn_plain(x, y, bf16, x_norms, y_norms)
    return (torch.sqrt(val) if sqrt else val), idx


#: ``fused_l2_nn``'s program, keyed per signature (``raft_tpu/distance/
#: fused_l2_nn.py:193`` ``_fused_l2_nn_aot``; ``core/prewarm.py`` warms
#: it)
_fused_l2_nn_aot = aot(_fused_l2_nn_impl, static_argnums=(2, 5, 6))


def fused_l2_nn_min_reduce(x, y, sqrt: bool = False, **kw) -> KeyValuePair:
    """Alias of :func:`fused_l2_nn` (reference ``fusedL2NNMinReduce``,
    fused_l2_nn.cuh:192)."""
    return fused_l2_nn(x, y, sqrt=sqrt, **kw)


@auto_sync_handle
def fused_l2_nn_argmin(x, y, sqrt: bool = True, handle=None, *,
                       device=None, engine: Optional[str] = None
                       ) -> torch.Tensor:
    """The nearest row's index alone (pylibraft ``fused_l2_nn_argmin``,
    distance/fused_l2_nn.pyx:64, ``auto_sync_handle`` there too).  A
    *handle* sets the device and issues the work on its stream."""
    return fused_l2_nn(x, y, sqrt=sqrt, device=handle.device
                       if handle is not None else device, engine=engine).key
