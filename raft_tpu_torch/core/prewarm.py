"""Hot-signature prewarming — the install-time half of the AOT story (port
of ``raft_tpu/core/prewarm.py:48``).

The reference ships ``libraft-distance`` / ``libraft-nn``, precompiled
instantiations of the known-hot (op, dtype) combinations
(cpp/src/distance/pairwise_distance.cu:24-52).  The port's counterpart is
two steps: build and load every kernel source into the active cache
directory (:func:`raft_tpu_torch.kernels.native.load_all`; point it with
:func:`raft_tpu_torch.core.aot.enable_persistent_cache` first to share it
across processes), then run the default grid of hot signatures once
through the module-level :class:`~raft_tpu_torch.core.aot.AotFunction`
wrappers, so each is warm.  A fresh process whose cache holds the
libraries builds nothing (``kernels.native.BUILDS["compiled"] == 0``).

The default grid is the reference's: the pairwise metrics of one engine
family each at ``BASELINE.json`` configs[0]'s own shape (5,000 × 5,000 ×
50) and at the k-means tile (2,048 × 1,024 × 128) — L1 is kernel B5 —
``fused_l2_nn`` at both (B1), and ``select_k`` at (1,024, 1,000, 40)
(B2).  IVF search signatures depend on the index; warm them per
deployment through ``extra`` (or ``ServeEngine.warmup``).  A failed build
or launch raises; nothing falls back.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch

from raft_tpu_torch.core.aot import TensorSpec, cache_dir
from raft_tpu_torch.core.handle import resolve_device

#: (m, n, k) grid of the pairwise engines: BASELINE configs[0] and the
#: k-means E-step tile
DEFAULT_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (5000, 5000, 50),
    (2048, 1024, 128),
)

#: one metric per engine family (the product epilogues, B5's L1)
DEFAULT_METRICS: Tuple[str, ...] = (
    "sqeuclidean", "euclidean", "cosine", "inner_product", "l1",
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prewarm(shapes: Sequence[Tuple[int, int, int]] = DEFAULT_SHAPES,
            metrics: Iterable[str] = DEFAULT_METRICS,
            dtypes: Iterable[str] = ("float32",),
            select_k_shapes: Sequence[Tuple[int, int, int]] = (
                (1024, 1000, 40),),
            extra: Optional[Iterable[Callable[[], object]]] = None,
            verbose: bool = False, device=None) -> dict:
    """Build the kernels into the cache directory and warm the grid on
    *device* (``None``: the card; on the CPU no kernel is built, since CPU
    tensors run the plain versions).  *extra*: zero-argument callables
    for deployment-specific signatures.  Returns ``{"n_signatures",
    "seconds", "cache_dir", "signatures"}``; ``signatures`` lists each
    one's name, its first call's seconds and a second, warm call's (the
    host's wall time to the device's end)."""
    from raft_tpu_torch.distance.distance_types import DISTANCE_TYPES
    from raft_tpu_torch.distance.fused_l2_nn import _fused_l2_nn_aot
    from raft_tpu_torch.distance.pairwise import _distance_aot
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.matrix.select_k import _select_k_aot

    dev = resolve_device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        native.load_all()
    signatures = []

    def run(name, fn):
        if verbose:
            print(f"prewarm: {name}", flush=True)
        times = []
        for _ in range(2):
            t = time.perf_counter()
            fn()
            _sync(dev)
            times.append(time.perf_counter() - t)
        signatures.append({"name": name, "first_s": times[0],
                           "warm_s": times[1]})

    for dtype in dtypes:
        dt = getattr(torch, dtype)
        for (m, n, k) in shapes:
            x = TensorSpec((m, k), dt, dev)
            y = TensorSpec((n, k), dt, dev)
            for name in metrics:
                metric = DISTANCE_TYPES[name]
                run(f"pairwise {name} {dtype} ({m},{n},{k})",
                    lambda: _distance_aot.compiled(x, y, metric, 2.0, None))
            run(f"fused_l2_nn {dtype} ({m},{n},{k})",
                lambda: _fused_l2_nn_aot.compiled(x, y, False, None, None,
                                                  "highest", None))
    for (rows, cols, k) in select_k_shapes:
        v = TensorSpec((rows, cols), torch.float32, dev)
        run(f"select_k ({rows},{cols}) k={k}",
            lambda: _select_k_aot.compiled(v, k, True, None, None))
    for i, fn in enumerate(extra or ()):
        run(f"extra[{i}]", fn)
    return {"n_signatures": len(signatures),
            "seconds": time.perf_counter() - t0,
            "cache_dir": cache_dir(),
            "signatures": signatures}
