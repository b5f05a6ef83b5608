"""The port's sparse pairwise distances
(``raft_tpu_torch.sparse.distance.pairwise_distance``) against the JAX
package's on the same seeded CSR inputs: all 18 metrics of
``SUPPORTED_SPARSE_DISTANCES`` × both engines (densify only where the JAX
package has it: not Jaccard or Dice), at rtol 1e-5 (Jensen–Shannon and
KL 1e-4), with several x- and y-blocks a call, empty rows, and the
engine ``auto`` picks above ``HIGHDIM_THRESHOLD``."""

import numpy as np
import pytest
import torch

import raft_tpu.sparse as js
from raft_tpu.distance import DistanceType as JDT
from raft_tpu.sparse import distance as jdist
from raft_tpu_torch import sparse as ts
from raft_tpu_torch.distance import DistanceType
from raft_tpu_torch.sparse import distance as tdist

CPU = "cpu"
METRICS = [m.name for m in tdist.SUPPORTED_SPARSE_DISTANCES]
LOOSE = ("JensenShannon", "KLDivergence")
#: every metric × engine the JAX package has (Jaccard and Dice are
#: sparse-only: no densify path)
CASES = [(m, e) for e in ("densify", "compressed") for m in METRICS
         if not (e == "densify" and m in ("JaccardExpanded", "DiceExpanded"))]


def random_csr(seed, m, dim, density, empty_rows=()):
    rng = np.random.default_rng(seed)
    mask = rng.random((m, dim)) < density
    mask[list(empty_rows)] = False
    r, c = np.nonzero(mask)
    v = rng.uniform(0.05, 1.0, len(r)).astype(np.float32)
    return (ts.from_triplets(r, c, v, (m, dim), device=CPU),
            js.from_triplets(r, c, v, (m, dim)))


@pytest.fixture(scope="module")
def inputs():
    return random_csr(0, 23, 40, 0.3, empty_rows=(4,)), \
        random_csr(1, 31, 40, 0.25, empty_rows=(0, 17))


def _check(metric, got, want):
    tol = 1e-4 if metric in LOOSE else 1e-5
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("metric,engine", CASES)
def test_metric_engine(metric, engine, inputs):
    (tx, jx), (ty, jy) = inputs
    p = 3.0
    got = tdist.pairwise_distance(tx, ty, DistanceType[metric], p=p,
                                  engine=engine, batch_size_x=8,
                                  batch_size_y=10)
    want = jdist.pairwise_distance(jx, jy, JDT[metric], p=p, engine=engine,
                                   batch_size_x=8, batch_size_y=10)
    assert got.shape == (23, 31) and got.device.type == "cpu"
    _check(metric, got, want)


def test_densify_refuses_sparse_only_metrics(inputs):
    (tx, _), (ty, _) = inputs
    for m in (DistanceType.JaccardExpanded, DistanceType.DiceExpanded):
        with pytest.raises(Exception, match="no densify path"):
            tdist.pairwise_distance(tx, ty, m, engine="densify")
    with pytest.raises(Exception, match="not supported"):
        tdist.pairwise_distance(tx, ty, DistanceType.Haversine)


@pytest.mark.parametrize("metric", ["CosineExpanded", "L1", "Linf"])
def test_highdim_auto_engine(metric):
    """Above HIGHDIM_THRESHOLD "auto" takes the compressed engine, with
    default batch sizes, and agrees with the JAX package."""
    dim = tdist.HIGHDIM_THRESHOLD + 904
    tx, jx = random_csr(2, 12, dim, 0.004)
    ty, jy = random_csr(3, 15, dim, 0.004)
    got = tdist.pairwise_distance(tx, ty, DistanceType[metric])
    want = jdist.pairwise_distance(jx, jy, JDT[metric])
    _check(metric, got, want)
    dense = tdist.pairwise_distance(tx, ty, DistanceType[metric],
                                    engine="densify")
    _check(metric, dense, want)


def test_empty_matrix_rows_and_self_distance():
    tx, jx = random_csr(4, 9, 16, 0.0)
    ty, jy = random_csr(5, 7, 16, 0.4)
    for metric in ("L2Expanded", "CosineExpanded", "L1"):
        got = tdist.pairwise_distance(tx, ty, DistanceType[metric],
                                      engine="compressed")
        want = jdist.pairwise_distance(jx, jy, JDT[metric],
                                       engine="compressed")
        _check(metric, got, want)
    d = tdist.pairwise_distance(ty, ty, DistanceType.L2SqrtExpanded)
    np.testing.assert_allclose(torch.diagonal(d).numpy(), 0.0, atol=1e-3)
