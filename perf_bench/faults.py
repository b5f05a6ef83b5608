"""Training faults planted in the port, for the readings that set the
limit of ``recall_miss`` (``control.py --fault``; a benchmark run never
plants one).

Each builds an index that is consistent with its own model — every row
in its nearest list, every code the nearest codeword of its residual —
from a model that was not trained as the configuration states.  So the
reference, which re-derives lists, codes and scores under the program's
model, finds nothing off, and only ``recall_miss`` (against brute force
over the raw dataset) can tell:

``coarse_untrained``
    the coarse centres are random rows of the training set (k-means with
    no iteration).
``kmeans_one_iter``
    every k-means (the coarse one; for IVF-PQ the codebooks' too) stops
    after its first iteration.
``codebooks_random`` (IVF-PQ)
    the codebooks are Gaussian draws of the residuals' scale.
``rotation_not_orthonormal`` (IVF-PQ)
    a Gaussian matrix takes the place of the PCA-balanced rotation.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Callable, Dict, Iterator, List, Tuple

_PQ = "raft_tpu_torch.neighbors.ivf_pq"
_FLAT = "raft_tpu_torch.neighbors.ivf_flat"


def _untrained(orig):
    import torch

    def build_hierarchical(rng, x, n_clusters, *args, **kwargs):
        gen = torch.Generator().manual_seed(int(rng.seed))
        pick = torch.randperm(x.shape[0], generator=gen)[:n_clusters]
        return x[pick.to(x.device)].clone()

    return build_hierarchical


def _random_codebooks(orig):
    import torch

    def train(gen, residuals, pq_dim, k, iters, engine):
        ds = residuals.shape[1] // pq_dim
        g = torch.Generator(device=residuals.device).manual_seed(7)
        return residuals.std() * torch.randn(
            pq_dim, k, ds, generator=g, device=residuals.device)

    return train


def _gaussian_rotation(orig):
    import numpy as np

    def rotation(resid_sample, pq_dim):
        dim = resid_sample.shape[1]
        r = np.random.default_rng(7).standard_normal((dim, dim))
        return (r / np.sqrt(dim)).astype(np.float32)

    return rotation


#: name -> (modules' attributes to replace, each with a maker taking the
#: original, and overrides of the configuration's ``index`` block)
FAULTS: Dict[str, Tuple[List[Tuple[str, str, Callable]], dict]] = {
    "coarse_untrained": ([(_PQ, "build_hierarchical", _untrained),
                          (_FLAT, "build_hierarchical", _untrained)], {}),
    "kmeans_one_iter": ([], {"kmeans_n_iters": 1}),
    "codebooks_random": ([(_PQ, "_train_codebooks_subspace",
                           _random_codebooks)], {}),
    "rotation_not_orthonormal": ([(_PQ, "_pca_balanced_rotation",
                                   _gaussian_rotation)], {}),
}


@contextlib.contextmanager
def planted(name: str, cfg: dict) -> Iterator[None]:
    """Plant the fault *name* in the port and in *cfg* (a cell's
    configuration, changed in place) until the block ends."""
    patches, overrides = FAULTS[name]
    saved = []
    try:
        for module, attr, make in patches:
            mod = importlib.import_module(module)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, make(getattr(mod, attr)))
        cfg["index"].update(overrides)
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)
