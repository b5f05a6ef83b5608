"""The legacy ``approx_knn_*`` surface (port of
``raft_tpu/neighbors/ann.py``; reference ``spatial/knn/ann.cuh:41,70``
and the parameter structs of ``spatial/knn/ann_common.h:84-104``): one
build and one search entry that dispatch on the parameter type to IVF-Flat
or IVF-PQ.

IVF-SQ (the reference delegates it to FAISS) maps onto IVF-Flat's int8
storage: the data and the queries go through one global 8-bit affine map
(:func:`_sq_encode`), which ranks L2 distances as the float data does, and
distances come back in the data's units.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import auto_sync_handle, device_of
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

_SQ_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded)


def _sq_encode(v: torch.Tensor, lo, scale) -> torch.Tensor:
    """The 8-bit affine code map the index and the queries share:
    round((v − lo) / scale) − 128, clipped to int8 (halves to even)."""
    return torch.clamp(torch.round((v - lo) / scale) - 128, -128, 127
                       ).to(torch.int8)


class QuantizerType(enum.Enum):
    """Reference ``QuantizerType`` (ann_common.h:73-81).  Only the 8-bit
    kinds map onto a storage type; the others raise."""

    QT_8bit = "QT_8bit"
    QT_4bit = "QT_4bit"
    QT_8bit_uniform = "QT_8bit_uniform"
    QT_4bit_uniform = "QT_4bit_uniform"
    QT_fp16 = "QT_fp16"
    QT_8bit_direct = "QT_8bit_direct"
    QT_6bit = "QT_6bit"


@dataclasses.dataclass
class IVFParam:
    """Reference ``IVFParam`` (ann_common.h:87-90)."""

    nlist: int = 1024
    nprobe: int = 20


@dataclasses.dataclass
class IVFFlatParam(IVFParam):
    """Reference ``IVFFlatParam`` (ann_common.h:92)."""


@dataclasses.dataclass
class IVFPQParam(IVFParam):
    """Reference ``IVFPQParam`` (ann_common.h:95-99): ``M`` subquantizers
    (pq_dim, 0 for the heuristic), ``n_bits`` bits per code."""

    M: int = 0
    n_bits: int = 8
    use_precomputed_tables: bool = False   # accepted; LUTs are per batch


@dataclasses.dataclass
class IVFSQParam(IVFParam):
    """Reference ``IVFSQParam`` (ann_common.h:101-104)."""

    qtype: QuantizerType = QuantizerType.QT_8bit
    encode_residual: bool = True   # accepted; the map is global


@dataclasses.dataclass
class KnnIndex:
    """Reference ``knnIndex`` (ann_common.h:35): metric, nprobe and
    exactly one index; ``sq_scale`` is IVF-SQ's (lo, scale)."""

    metric: DistanceType
    metric_arg: float
    nprobe: int
    ivf_flat_index: Optional[ivf_flat.Index] = None
    ivf_pq_index: Optional[ivf_pq.Index] = None
    sq_scale: Optional[Tuple[float, float]] = None


@auto_sync_handle
def approx_knn_build_index(params: IVFParam, data,
                           metric: DistanceType = DistanceType.L2Expanded,
                           metric_arg: float = 2.0, handle=None, *,
                           device=None, engine: Optional[str] = None
                           ) -> KnnIndex:
    """Build the index the parameter type names (reference
    ``approx_knn_build_index``, spatial/knn/ann.cuh:41), on *device*
    (``None``: the card) or the *handle*'s, on whose stream the work
    runs."""
    dev = device_of(handle, device)
    x = torch.as_tensor(data, device=dev)
    if isinstance(params, IVFPQParam):
        idx = ivf_pq.build(
            ivf_pq.IndexParams(n_lists=params.nlist, metric=metric,
                               pq_dim=params.M, pq_bits=params.n_bits),
            x, handle=handle, device=dev, engine=engine)
        return KnnIndex(metric, metric_arg, params.nprobe, ivf_pq_index=idx)
    if isinstance(params, IVFSQParam):
        # one global (lo, scale) for every 8-bit kind: a per-dimension
        # range would weigh each dimension's squared distance differently
        # in code space, which would no longer rank as L2 does
        expects(params.qtype in (QuantizerType.QT_8bit,
                                 QuantizerType.QT_8bit_uniform,
                                 QuantizerType.QT_8bit_direct),
                f"ann: no storage mapping for {params.qtype}")
        expects(metric in _SQ_METRICS,
                "ann: IVF-SQ supports L2Expanded/L2SqrtExpanded only")
        xf = x.float()
        lo, hi = torch.amin(xf), torch.amax(xf)
        scale = torch.clamp_min(hi - lo, 1e-30) / 255.0
        idx = ivf_flat.build(
            ivf_flat.IndexParams(n_lists=params.nlist, metric=metric),
            _sq_encode(xf, lo, scale), handle=handle, device=dev,
            engine=engine)
        return KnnIndex(metric, metric_arg, params.nprobe,
                        ivf_flat_index=idx,
                        sq_scale=(float(lo), float(scale)))
    expects(isinstance(params, IVFParam), "ann: unknown param type")
    idx = ivf_flat.build(
        ivf_flat.IndexParams(n_lists=params.nlist, metric=metric), x,
        handle=handle, device=dev, engine=engine)
    return KnnIndex(metric, metric_arg, params.nprobe, ivf_flat_index=idx)


@auto_sync_handle
def approx_knn_search(index: KnnIndex, queries, k: int, handle=None, *,
                      engine: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search whichever index *index* holds (reference
    ``approx_knn_search``, spatial/knn/ann.cuh:70): (distances (nq, k),
    indices (nq, k)) on its device.  With a *handle* the work runs on its
    streams (IVF-PQ query batches on its pool)."""
    if index.ivf_pq_index is not None:
        return ivf_pq.search(ivf_pq.SearchParams(n_probes=index.nprobe),
                             index.ivf_pq_index, queries, k, handle=handle,
                             engine=engine)
    expects(index.ivf_flat_index is not None, "ann: empty index")
    flat = index.ivf_flat_index
    params = ivf_flat.SearchParams(n_probes=index.nprobe)
    if index.sq_scale is None:
        return ivf_flat.search(params, flat, queries, k, handle=handle,
                               engine=engine)
    lo, scale = (torch.tensor(v, dtype=torch.float32, device=flat.device)
                 for v in index.sq_scale)
    q = torch.as_tensor(queries, device=flat.device).float()
    d, i = ivf_flat.search(params, flat, _sq_encode(q, lo, scale), k,
                           handle=handle, engine=engine)
    # code units back to the data's (the L2 family only, held at build)
    factor = (scale if index.metric == DistanceType.L2SqrtExpanded
              else scale * scale)
    return d * factor, i
