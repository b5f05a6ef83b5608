"""IVF-PQ approximate nearest-neighbour index (port of
``raft_tpu/neighbors/ivf_pq.py``; reference neighbors/ivf_pq.cuh).

Two-level quantization ``y ≈ Q1(y) + Q2(y − Q1(y))``: coarse balanced
k-means centres (kernels B3 and B1 on the card) plus product-quantized,
rotated residuals, bit-packed LSB-first at pq_bits (4–8) bits a code in
chunked padded lists (``_common.pack_lists``).

Build: coarse quantizer → list assignment → rotation (the PCA-balanced
one by default, a QR of a Gaussian otherwise) → one codebook per subspace,
trained by Lloyd k-means whose every E-step is kernel B3 → encode in row
tiles of 8,192 → pack, with the build-time list-side ADC tables
``list_adc`` and its per-candidate contraction ``list_csum``.

Search, per query batch (the hoisted-ADC path): coarse GEMM → top-n_probes
(kernel B2) → one per-batch LUT stage → the probe scan, whose every step
scores each query's probed row with kernel B4 (``kernels.ivf_pq_lut``,
codes read in place) and keeps the best k (kernel B2).  With the float32
LUT the LUT is probe-invariant (the list-side term enters per candidate
through ``list_csum``); a compressed LUT (bfloat16, float16, float8 e4m3)
is the per-probe combined table, quantized with one affine per query and
threaded through the scan as per-step ``xs``.

A query's result bits do not depend on the batch it rides in (the serving
contract): the rotation and the coarse products run in the fixed
1,024-row blocks of ``distance.pairwise._dot_fixed_rows`` and the
query-cross LUT is a broadcast multiply and sum over the subspace width,
not a batched GEMM.

Not ported yet (each raises): PER_CLUSTER codebooks,
``internal_distance_dtype="float16"``, the non-hoisted search
(``hoisted_lut=False``), extend into a non-empty index, ``build_sharded``
and the tombstone mask.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans import (centroids_from_sums,
                                           fused_em_step_batched)
from raft_tpu_torch.cluster.kmeans_balanced import build_hierarchical
from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import LogicError, expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import _dot_fixed_rows
from raft_tpu_torch.kernels import ivf_pq_lut
from raft_tpu_torch.kernels.engine import resolve_engine
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors._common import (empty_result, expand_probes,
                                              pack_lists, scan_probe_lists,
                                              subsample_trainset)
from raft_tpu_torch.neighbors.ivf_flat import (_assign_lists,
                                               _coarse_distances)
from raft_tpu_torch.random.rng import RngState

_SUPPORTED = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
              DistanceType.InnerProduct)
_LUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16, "float8_e4m3": torch.float8_e4m3fn}
#: fp8 e4m3's largest finite value is 448; LUTs quantize to [0, 440]
_FP8_PEAK = 440.0
#: the JAX Index leaves, in order (``raft_tpu`` ivf_pq.py:307-311)
ARRAY_FIELDS = ("centers", "rotation", "codebooks", "list_codes",
                "list_indices", "list_sizes", "phys_sizes", "chunk_table",
                "owner", "list_adc", "list_csum")
_FLOAT_FIELDS = ("centers", "rotation", "codebooks", "list_adc", "list_csum")
#: rows per encode tile: bounds the (tile, pq_dim, 2^bits) distance
_TILE_ROWS = 8192
#: rows of the residual sample the PCA-balanced rotation is fitted on
_PCA_SAMPLE = 50_000
_NOT_PORTED = "is not ported yet"


class CodebookKind(enum.IntEnum):
    """Reference ``codebook_gen`` (ivf_pq_types.hpp:31)."""

    PER_SUBSPACE = 0
    PER_CLUSTER = 1


@dataclasses.dataclass
class IndexParams:
    """Reference ``ivf_pq::index_params`` (ivf_pq_types.hpp:36)."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    pq_bits: int = 8
    pq_dim: int = 0          # 0 → heuristic (_calc_pq_dim)
    codebook_kind: CodebookKind = CodebookKind.PER_SUBSPACE
    force_random_rotation: bool = False
    add_data_on_build: bool = True
    # "auto": "pca_balanced" whenever pq_dim | dim, else "default"
    rotation_kind: str = "auto"
    pq_trainset_cap: int = 262144
    seed: int = 1234


@dataclasses.dataclass
class SearchParams:
    """Reference ``ivf_pq::search_params`` (ivf_pq_types.hpp:88)."""

    n_probes: int = 20
    lut_dtype: str = "float32"   # float32 | bfloat16 | float16 | float8_e4m3
    internal_distance_dtype: str = "float32"
    hoisted_lut: Optional[bool] = None    # False (legacy path): not ported


@dataclasses.dataclass
class Index:
    """IVF-PQ index (the JAX ``Index`` leaves):

    ``centers``      (n_lists, dim) f32 coarse centroids
    ``rotation``     (dim, rot_dim) f32 orthonormal transform
    ``codebooks``    (pq_dim, 2^bits, ds) f32, ds = rot_dim // pq_dim
    ``list_codes``   (n_phys+1, cap, ⌈pq_dim·bits/8⌉) uint8, bit-packed
    ``list_indices`` (n_phys+1, cap) int32, −1 at padding
    ``list_sizes``   (n_lists,) int32 logical sizes
    ``phys_sizes``   (n_phys+1,) int32 live rows per physical chunk
    ``chunk_table``  (n_lists, max_chunks) int32 logical → physical rows
    ``owner``        (n_phys+1,) int32 logical list of each physical row
    ``list_adc``     (n_lists, pq_dim, 2^bits) f32: ‖cb‖² + 2·ctr_rot·cb
    ``list_csum``    (n_phys+1, cap) f32: Σ_m list_adc[owner, m, code_m]
    ``rot_centers``  (n_lists, rot_dim) f32 = centers @ rotation, made
                     once when the index is made
    """

    centers: torch.Tensor
    rotation: torch.Tensor
    codebooks: torch.Tensor
    list_codes: torch.Tensor
    list_indices: torch.Tensor
    list_sizes: torch.Tensor
    phys_sizes: torch.Tensor
    chunk_table: torch.Tensor
    owner: torch.Tensor
    list_adc: torch.Tensor
    list_csum: torch.Tensor
    metric: DistanceType
    codebook_kind: CodebookKind
    pq_bits: int
    dataset_dtype: str = "float32"
    rot_centers: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.rot_centers = self.centers @ self.rotation

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def pq_dim(self) -> int:
        return self.codebooks.shape[0]

    @property
    def capacity(self) -> int:
        return self.list_codes.shape[1]

    @property
    def size(self) -> int:
        return int(torch.sum(self.list_sizes))

    @property
    def padding_fraction(self) -> float:
        total = self.list_codes.shape[0] * self.capacity
        return 1.0 - self.size / max(total, 1)


def _ingest_dataset(data, device) -> Tuple[torch.Tensor, str]:
    """(float32 tensor on *device*, dtype tag): int8/uint8 widen exactly
    and keep their tag; any other floating type computes in float32."""
    x = torch.as_tensor(data, device=device)
    if x.dtype in (torch.int8, torch.uint8):
        return x.to(torch.float32), str(x.dtype).replace("torch.", "")
    expects(x.dtype.is_floating_point,
            f"ivf_pq: unsupported dataset dtype {x.dtype}; the reference "
            "supports T in {float, int8_t, uint8_t}")
    return x.to(torch.float32), "float32"


def _code_bytes(pq_dim: int, pq_bits: int) -> int:
    return -(-pq_dim * pq_bits // 8)


def _pack_codes(codes: torch.Tensor, pq_bits: int) -> torch.Tensor:
    """Bit-pack (n, pq_dim) codes into (n, ⌈pq_dim·bits/8⌉) uint8, an
    LSB-first bitstream; pq_bits = 8 is the identity."""
    if pq_bits == 8:
        return codes.to(torch.uint8)
    n, pq_dim = codes.shape
    dev = codes.device
    total = pq_dim * pq_bits
    nbytes = _code_bytes(pq_dim, pq_bits)
    bits = (codes.to(torch.int32)[:, :, None]
            >> torch.arange(pq_bits, device=dev, dtype=torch.int32)) & 1
    bits = bits.reshape(n, total)
    if nbytes * 8 != total:
        bits = torch.cat([bits, bits.new_zeros((n, nbytes * 8 - total))], 1)
    byte = torch.sum(bits.reshape(n, nbytes, 8)
                     << torch.arange(8, device=dev, dtype=torch.int32), -1)
    return byte.to(torch.uint8)


_unpack_codes = ivf_pq_lut.unpack_codes


def _calc_pq_dim(dim: int) -> int:
    """pq_dim when 0: about dim / 2, rounded up to a multiple of 8."""
    d = max(1, dim // 2)
    if d >= 8:
        d = -(-d // 8) * 8
    return d


def _make_rotation(gen: torch.Generator, dim: int, rot_dim: int,
                   random: bool) -> torch.Tensor:
    """Identity, or the first (dim, rot_dim) block of the Q of a QR of a
    Gaussian square matrix drawn from *gen*."""
    if not random and dim == rot_dim:
        return torch.eye(dim, dtype=torch.float32)
    size = max(dim, rot_dim)
    q, _ = torch.linalg.qr(torch.randn(size, size, generator=gen,
                                       dtype=torch.float32))
    return q[:dim, :rot_dim].contiguous()


def _pca_balanced_rotation(resid_sample: np.ndarray, pq_dim: int
                           ) -> np.ndarray:
    """Parametric OPQ rotation (the JAX package's numpy code): the eigen
    basis of the residual covariance, eigen-directions allocated greedily
    to the pq_dim subspaces so the variance products balance (Ge et al.
    2013).  Orthogonal (dim, dim); subspace m takes columns
    [m·ds, (m+1)·ds)."""
    dim = resid_sample.shape[1]
    ds = dim // pq_dim
    cov = np.cov(resid_sample.T).astype(np.float64)
    w, v = np.linalg.eigh(cov)                       # ascending
    w, v = w[::-1], v[:, ::-1]                       # descending variance
    buckets: list = [[] for _ in range(pq_dim)]
    logvar = np.zeros(pq_dim)
    for i in range(dim):
        open_b = [b for b in range(pq_dim) if len(buckets[b]) < ds]
        b = min(open_b, key=lambda bb: logvar[bb])
        buckets[b].append(i)
        logvar[b] += np.log(max(float(w[i]), 1e-12))
    order = [i for b in buckets for i in b]
    return np.ascontiguousarray(v[:, order], dtype=np.float32)


def _sub_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_j a[..., j] · b[..., j] over the (short) subspace width, one
    broadcast multiply-add per j: no batched GEMM (whose algorithm, and so
    whose bits, cuBLAS picks by shape) and no (…, ds) product transient."""
    out = a[..., 0] * b[..., 0]
    for j in range(1, a.shape[-1]):
        out = out + a[..., j] * b[..., j]
    return out


def _lloyd_kmeans(gen: torch.Generator, data: torch.Tensor, k: int,
                  iters: int, engine: Optional[str]) -> torch.Tensor:
    """Plain Lloyd k-means for S codebooks at once: data (S, n, d) →
    centres (S, k, d).  The S initial centre sets are drawn first, in the
    order one codebook at a time would draw them (a Lloyd step draws
    nothing); then every iteration is one batched fused EM step (kernel B3
    on the card: one launch for all S, the nearest centre and the members'
    sums) and one batched centroid update; an empty cluster keeps its
    centre — what the JAX package's ``jax.vmap`` of its Lloyd step
    computes, without the (S, n, k) distance tensor."""
    s, n, d = data.shape
    sels = [torch.randperm(n, generator=gen)[:k] if n >= k
            else torch.randint(0, n, (k,), generator=gen) for _ in range(s)]
    sel = torch.stack(sels).to(data.device)
    centers = torch.gather(data, 1, sel[..., None].expand(s, k, d))
    for _ in range(iters):
        p = fused_em_step_batched(data, centers, engine=engine)
        centers = centroids_from_sums(p.sums, p.weights, centers,
                                      torch.float32)
    return centers


def _train_codebooks_subspace(gen: torch.Generator, residuals: torch.Tensor,
                              pq_dim: int, k: int, iters: int,
                              engine: Optional[str]) -> torch.Tensor:
    """PER_SUBSPACE: one codebook per subspace, (pq_dim, k, ds), all
    subspaces trained together (``raft_tpu``'s ``jax.vmap`` over them)."""
    n, rot_dim = residuals.shape
    ds = rot_dim // pq_dim
    sub = residuals.reshape(n, pq_dim, ds).transpose(0, 1).contiguous()
    return _lloyd_kmeans(gen, sub, k, iters, engine)


def _encode(residuals: torch.Tensor, codebooks: torch.Tensor
            ) -> torch.Tensor:
    """PQ-encode rotated residuals → (n, pq_dim) uint8: per subspace the
    nearest codeword by ‖sub‖² + ‖cb‖² − 2·sub·cb, the earlier codeword
    winning ties (``torch.argmin`` returns the first minimum)."""
    n, rot_dim = residuals.shape
    pq_dim, _, ds = codebooks.shape
    sub = residuals.reshape(n, pq_dim, ds)
    d = (torch.sum(sub * sub, -1)[:, :, None]
         + torch.sum(codebooks * codebooks, -1)[None, :, :]
         - 2.0 * _sub_dot(sub[:, :, None, :], codebooks[None]))
    return torch.argmin(d, dim=-1).to(torch.uint8)


def _build_list_adc(rot_centers: torch.Tensor, codebooks: torch.Tensor
                    ) -> torch.Tensor:
    """Build-time list-side ADC table (n_lists, pq_dim, 2^bits) f32:
    ``list_adc[l, m, k] = ‖cb[m, k]‖² + 2·ctr_rot[l, m]·cb[m, k]``."""
    pq_dim, _, ds = codebooks.shape
    ctr = rot_centers.reshape(-1, pq_dim, ds)
    cb_sq = torch.sum(codebooks * codebooks, -1)           # (pq_dim, kcb)
    return cb_sq[None] + 2.0 * _sub_dot(ctr[:, :, None, :], codebooks[None])


def _csum_for_codes(codes: torch.Tensor, labels: torch.Tensor,
                    rot_centers: torch.Tensor, codebooks: torch.Tensor
                    ) -> torch.Tensor:
    """Per candidate Σ_m list_adc[label, m, code_m] = ‖decoded‖² +
    2·ctr_rot[label]·decoded, through the decoded rotated residual."""
    n = codes.shape[0]
    pq_dim = codebooks.shape[0]
    m = torch.arange(pq_dim, device=codes.device)
    dec = codebooks[m[None, :], codes.long()].reshape(n, -1)  # (n, rot_dim)
    ctr = rot_centers[labels.long()]
    return torch.sum(dec * dec, -1) + 2.0 * torch.sum(ctr * dec, -1)


def _csum_for_packed(list_codes: torch.Tensor, owner: torch.Tensor,
                     rot_centers: torch.Tensor, codebooks: torch.Tensor,
                     pq_bits: int, tile_phys: int = 1024) -> torch.Tensor:
    """``list_csum`` of an already packed code block (a v1 archive),
    unpacked ``tile_phys`` physical rows at a time; padding slots get
    values that the live-slot mask discards."""
    rows, cap = list_codes.shape[0], list_codes.shape[1]
    pq_dim = codebooks.shape[0]
    out = []
    for r0 in range(0, rows, tile_phys):
        r1 = min(r0 + tile_phys, rows)
        codes = _unpack_codes(list_codes[r0:r1].reshape((r1 - r0) * cap, -1),
                              pq_dim, pq_bits)
        labels = torch.repeat_interleave(owner[r0:r1], cap)
        out.append(_csum_for_codes(codes, labels, rot_centers, codebooks
                                   ).reshape(r1 - r0, cap))
    return torch.cat(out) if out else rot_centers.new_zeros((0, cap))


def _validate_build(params: IndexParams, x: torch.Tensor) -> None:
    expects(x.ndim == 2, "dataset must be (n, dim)")
    expects(params.metric in _SUPPORTED,
            f"ivf_pq: unsupported metric {params.metric}")
    expects(4 <= params.pq_bits <= 8,
            "pq_bits must be in [4, 8] (ivf_pq_types.hpp:52)")
    expects(params.rotation_kind in ("auto", "default", "pca_balanced"),
            f"unknown rotation_kind {params.rotation_kind!r}")
    expects(params.codebook_kind == CodebookKind.PER_SUBSPACE,
            f"ivf_pq: codebook_kind=PER_CLUSTER {_NOT_PORTED}")


def _sample_rows(n: int, size: int, seed: int) -> np.ndarray:
    return np.sort(np.random.default_rng(seed).choice(n, size=size,
                                                      replace=False))


def _train_model(params: IndexParams, x: torch.Tensor,
                 engine: Optional[str]):
    """Coarse quantizer, assignment, rotation, codebooks.  Returns
    (centers, labels, rotation, codebooks)."""
    n, dim = x.shape
    dev = x.device
    n_lists = min(params.n_lists, n)
    pq_dim = params.pq_dim or _calc_pq_dim(dim)
    rot_dim = -(-dim // pq_dim) * pq_dim
    rotation_kind = params.rotation_kind
    if rotation_kind == "auto":
        rotation_kind = "pca_balanced" if rot_dim == dim else "default"
    expects(rotation_kind != "pca_balanced" or rot_dim == dim,
            "rotation_kind='pca_balanced' needs pq_dim | dim")
    k = 1 << params.pq_bits
    # subsequence 0 of the seed is the coarse trainer's
    rng = RngState(params.seed, base_subsequence=1)

    train = subsample_trainset(x, params.kmeans_trainset_fraction, n_lists,
                               params.seed)
    centers = build_hierarchical(RngState(params.seed), train, n_lists,
                                 params.kmeans_n_iters, engine=engine)
    del train
    # the lists must agree with how search ranks probes: max-dot for
    # inner product, else min-L2 (kernel B1)
    labels = _assign_lists(x, centers, params.metric, engine)

    if rotation_kind == "pca_balanced":
        sel = torch.as_tensor(_sample_rows(n, min(n, _PCA_SAMPLE),
                                           params.seed + 7), device=dev)
        resid = (x[sel] - centers[labels[sel].long()]).cpu().numpy()
        rotation = torch.as_tensor(_pca_balanced_rotation(resid, pq_dim))
    else:
        rotation = _make_rotation(rng.next_generator(), dim, rot_dim,
                                  params.force_random_rotation
                                  or rot_dim != dim)
    rotation = rotation.to(dev)

    cap_t = max(int(params.pq_trainset_cap), k)
    if n > cap_t:
        sel_t = torch.as_tensor(_sample_rows(n, cap_t, params.seed + 13),
                                device=dev)
        x_t, lab_t = x[sel_t], labels[sel_t]
    else:
        x_t, lab_t = x, labels
    resid_t = (x_t - centers[lab_t.long()]) @ rotation
    codebooks = _train_codebooks_subspace(rng.next_generator(), resid_t,
                                          pq_dim, k, params.kmeans_n_iters,
                                          engine)
    return centers, labels, rotation, codebooks


def _encode_rows(index: Index, x: torch.Tensor, labels: torch.Tensor):
    """(packed codes, csum) of *x*'s rows under *index*'s model, in row
    tiles: residual → rotate → encode → pack, and the per-candidate
    list-side sum."""
    packed, csum = [], []
    for r0 in range(0, x.shape[0], _TILE_ROWS):
        xt = x[r0:r0 + _TILE_ROWS]
        lt = labels[r0:r0 + _TILE_ROWS].long()
        codes = _encode((xt - index.centers[lt]) @ index.rotation,
                        index.codebooks)
        packed.append(_pack_codes(codes, index.pq_bits))
        csum.append(_csum_for_codes(codes, lt, index.rot_centers,
                                    index.codebooks))
    if not packed:
        return (torch.zeros((0, _code_bytes(index.pq_dim, index.pq_bits)),
                            dtype=torch.uint8, device=x.device),
                torch.zeros(0, device=x.device))
    return torch.cat(packed), torch.cat(csum)


def _empty_index(centers, rotation, codebooks, metric, pq_bits: int,
                 dataset_dtype: str) -> Index:
    dev = centers.device
    n_lists = centers.shape[0]
    nbytes = _code_bytes(codebooks.shape[0], pq_bits)
    return Index(
        centers=centers, rotation=rotation, codebooks=codebooks,
        list_codes=torch.zeros((1, 8, nbytes), dtype=torch.uint8, device=dev),
        list_indices=torch.full((1, 8), -1, dtype=torch.int32, device=dev),
        list_sizes=torch.zeros(n_lists, dtype=torch.int32, device=dev),
        phys_sizes=torch.zeros(1, dtype=torch.int32, device=dev),
        chunk_table=torch.zeros((n_lists, 1), dtype=torch.int32, device=dev),
        owner=torch.zeros(1, dtype=torch.int32, device=dev),
        list_adc=_build_list_adc(centers @ rotation, codebooks),
        list_csum=torch.zeros((1, 8), device=dev), metric=metric,
        codebook_kind=CodebookKind.PER_SUBSPACE, pq_bits=pq_bits,
        dataset_dtype=dataset_dtype)


def build(params: IndexParams, dataset, ids=None, *, device=None,
          engine: Optional[str] = None) -> Index:
    """Train and populate an IVF-PQ index (reference ``ivf_pq::build``).
    *dataset* is an (n, dim) float32, int8 or uint8 array or tensor;
    ``device=None`` runs on the card.  ``engine`` picks the kernels
    (``"cuda"``) or their plain versions (``"torch"``) for the E-steps."""
    dev = resolve_device(device)
    x, dataset_dtype = _ingest_dataset(dataset, dev)
    _validate_build(params, x)
    centers, labels, rotation, codebooks = _train_model(params, x, engine)
    index = _empty_index(centers, rotation, codebooks, params.metric,
                         params.pq_bits, dataset_dtype)
    if params.add_data_on_build:
        return _populate(index, x, ids, labels)
    expects(ids is None, "ids were passed but add_data_on_build=False "
            "stores no rows — pass them to extend() instead")
    return index


def _populate(index: Index, x: torch.Tensor, ids, labels: torch.Tensor
              ) -> Index:
    n = x.shape[0]
    dev = index.device
    if ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=dev)
    else:
        ids = torch.as_tensor(ids, device=dev).to(torch.int32)
        expects(ids.shape == (n,), "ids must be (n_new,)")
        expects(torch.unique(ids).numel() == n,
                "extend: duplicate ids within new_ids")
    packed, csum = _encode_rows(index, x, labels)
    ((list_codes, list_csum), list_indices, phys_sizes, list_sizes,
     chunk_table, owner) = pack_lists((packed, csum), ids, labels,
                                      index.n_lists)
    return Index(centers=index.centers, rotation=index.rotation,
                 codebooks=index.codebooks, list_codes=list_codes,
                 list_indices=list_indices, list_sizes=list_sizes,
                 phys_sizes=phys_sizes, chunk_table=chunk_table, owner=owner,
                 list_adc=index.list_adc, list_csum=list_csum,
                 metric=index.metric, codebook_kind=index.codebook_kind,
                 pq_bits=index.pq_bits, dataset_dtype=index.dataset_dtype)


def extend(index: Index, new_vectors, new_ids=None, *,
           engine: Optional[str] = None) -> Index:
    """Add vectors to an EMPTY index (reference ``ivf_pq::extend``):
    assign, encode with the trained model and pack.  Appending into a
    non-empty index is not ported yet and raises."""
    x, new_dtype = _ingest_dataset(new_vectors, index.device)
    expects(new_dtype == index.dataset_dtype,
            f"extend dtype {new_dtype} != index dataset dtype "
            f"{index.dataset_dtype}")
    expects(x.ndim == 2 and x.shape[1] == index.dim, "dim mismatch")
    expects(index.size == 0,
            f"ivf_pq.extend: appending into a non-empty index {_NOT_PORTED}")
    labels = _assign_lists(x, index.centers, index.metric, engine)
    return _populate(index, x, new_ids, labels)


def build_sharded(params: IndexParams, dataset, comms, ids=None):
    """Train once and populate straight into list shards (the JAX
    package's ``build_sharded``): not ported yet — the port has no
    communicator layer."""
    raise LogicError(f"ivf_pq.build_sharded {_NOT_PORTED}")


def index_from_arrays(arrays: Dict[str, np.ndarray], metric,
                      codebook_kind=CodebookKind.PER_SUBSPACE,
                      pq_bits: int = 8, dataset_dtype: str = "float32",
                      device=None) -> Index:
    """An :class:`Index` from the JAX ``Index`` leaves as numpy arrays under
    their field names (:data:`ARRAY_FIELDS`) — e.g. an index the JAX
    package built."""
    dev = resolve_device(device)
    expects(CodebookKind(int(codebook_kind)) == CodebookKind.PER_SUBSPACE,
            f"ivf_pq: codebook_kind=PER_CLUSTER {_NOT_PORTED}")
    vals = {}
    for name in ARRAY_FIELDS:
        dt = (np.float32 if name in _FLOAT_FIELDS
              else np.uint8 if name == "list_codes" else np.int32)
        vals[name] = torch.as_tensor(np.array(arrays[name], dt), device=dev)
    return Index(**vals, metric=DistanceType(int(metric)),
                 codebook_kind=CodebookKind.PER_SUBSPACE,
                 pq_bits=int(pq_bits), dataset_dtype=str(dataset_dtype))


def index_to_arrays(index: Index) -> Dict[str, np.ndarray]:
    """Inverse of :func:`index_from_arrays`."""
    return {name: getattr(index, name).cpu().numpy() for name in ARRAY_FIELDS}


def _quantize_lut(lut: torch.Tensor, base: torch.Tensor, lut_dtype_name: str):
    """Quantize the per-batch LUT (nq, P, pq_dim, kcb) f32 (P = 1 when
    probe-invariant) → (lut_q, base', scale (nq,)).  fp8: each (query,
    probe, subspace) row shifts to 0 (the shift re-enters exactly through
    base'), then ONE scale per query over its whole probe set maps the
    peak to :data:`_FP8_PEAK`, so scores from different probes of one
    query stay comparable; the scan inverts the map in f32."""
    nq = lut.shape[0]
    if lut_dtype_name != "float8_e4m3":
        return (lut.to(_LUT_DTYPES[lut_dtype_name]), base,
                torch.ones(nq, dtype=torch.float32, device=lut.device))
    lo = torch.amin(lut, dim=-1, keepdim=True)      # (nq, P, pq_dim, 1)
    lut0 = lut - lo
    scale = _FP8_PEAK / torch.clamp_min(torch.amax(lut0, dim=(1, 2, 3)),
                                        1e-30)      # (nq,)
    lut_q = (lut0 * scale[:, None, None, None]).to(torch.float8_e4m3fn)
    return lut_q, base + torch.sum(lo[..., 0], dim=-1), scale


def _scan_hoisted(q: torch.Tensor, probe_ids: torch.Tensor,
                  rot_q: torch.Tensor, index: Index, k: int,
                  lut_dtype_name: str, engine: str, lut_engine: str):
    """Hoisted-ADC probe scan: one LUT stage for the batch, then a scan
    whose step is a table lookup (kernel B4) plus the epilogue.

    float32 LUT (or IP): the query-cross LUT is probe-invariant,
    (nq, pq_dim·kcb); the list-side term enters per candidate through
    ``list_csum``.  Compressed LUT (L2): the per-probe combined table
    ``list_adc[probe] − 2·rot_q·cb``, quantized with one affine per query,
    its probe slices threaded as per-step ``xs``.  ‖r‖² (L2) or q·c (IP)
    rides the exact f32 per-(query, probe) base."""
    nq = q.shape[0]
    pq_dim, kcb, ds = index.codebooks.shape
    is_ip = index.metric == DistanceType.InnerProduct
    q_sub = rot_q.reshape(nq, pq_dim, ds)
    combine = (not is_ip) and lut_dtype_name != "float32"
    qlut = _sub_dot(q_sub[:, :, None, :], index.codebooks[None])[:, None]
    if is_ip:
        lut = qlut
        base = torch.sum(q[:, None, :] * index.centers[probe_ids.long()], -1)
    else:
        lut = -2.0 * qlut
        if combine:
            lut = index.list_adc[probe_ids.long()] + lut  # (nq, P, m, kcb)
        rc = index.rot_centers[probe_ids.long()]          # (nq, P, rot_dim)
        diff = rot_q[:, None, :] - rc
        base = torch.sum(diff * diff, -1)
    lut_q, base, scale = _quantize_lut(lut, base, lut_dtype_name)
    lut_q = lut_q.reshape(nq, lut_q.shape[1], pq_dim * kcb)

    phys, probe_ord = expand_probes(probe_ids, index.chunk_table,
                                    index.list_codes.shape[0],
                                    return_ord=True)
    base_xs = torch.gather(base, 1, probe_ord).T.contiguous()  # (steps, nq)
    if combine:
        # gathered as raw bits: index kernels need not cover float8
        bits = (lut_q.view(torch.uint8) if lut_q.element_size() == 1
                else lut_q)
        lut_xs = bits[torch.arange(nq, device=q.device)[:, None], probe_ord]
        xs = (lut_xs.transpose(0, 1).contiguous().view(lut_q.dtype), base_xs)
    else:
        lut_flat = lut_q[:, 0].contiguous()
        xs = (base_xs,)
    add_csum = not is_ip and not combine
    fp8_scale = scale[:, None] if lut_dtype_name == "float8_e4m3" else None

    def lookup(rows, lut_t):
        if lut_engine == "cuda":
            return ivf_pq_lut.lut_score_rows(index.list_codes, rows, lut_t,
                                             pq_dim, index.pq_bits, kcb)
        return ivf_pq_lut._lut_score_plain(index.list_codes[rows.long()],
                                           lut_t, pq_dim, index.pq_bits, kcb)

    def finish(rows, acc, base_t):
        s = acc if fp8_scale is None else acc / fp8_scale
        s = s + base_t[:, None]
        return s + index.list_csum[rows.long()] if add_csum else s

    if combine:
        def score_tile(rows, lut_t, base_t):
            return finish(rows, lookup(rows, lut_t), base_t)
    else:
        def score_tile(rows, base_t):
            return finish(rows, lookup(rows, lut_flat), base_t)

    return scan_probe_lists(phys, score_tile, index.list_indices,
                            index.phys_sizes, k, select_min=not is_ip,
                            dtype=torch.float32, engine=engine, xs=xs)


def _resolve_engines(index: Index,
                     engine: Optional[str]) -> Tuple[str, str]:
    """(select_k engine, pq_lut engine) for one knob: ``None`` follows the
    device, ``"cuda"`` asks for both kernels, ``"torch"`` for both plain
    versions."""
    return (resolve_engine("select_k", index.device, engine=engine),
            resolve_engine("pq_lut", index.device, engine=engine))


def _search_batch_impl(q: torch.Tensor, probe_ids: torch.Tensor,
                       index: Index, k: int, lut_dtype_name: str,
                       engines: Tuple[str, str]):
    """Score the probed lists of one query batch and keep the best k."""
    rot_q = _dot_fixed_rows(q, index.rotation.T)          # (nq, rot_dim)
    best_d, best_i = _scan_hoisted(q, probe_ids, rot_q, index, k,
                                   lut_dtype_name, *engines)
    if index.metric == DistanceType.L2SqrtExpanded:
        best_d = torch.sqrt(torch.clamp_min(best_d, 0.0))
    return best_d, best_i


def _full_search_impl(queries: torch.Tensor, index: Index, k: int,
                      n_probes: int, lut_dtype_name: str,
                      engines: Tuple[str, str]):
    """Coarse ranking + top-n_probes + probe scoring of one batch — the
    serving entry point."""
    coarse = _coarse_distances(queries, index.centers, index.metric)
    _, probes = select_k(coarse, n_probes, select_min=True,
                         engine=engines[0])
    return _search_batch_impl(queries, probes, index, k, lut_dtype_name,
                              engines)


def hoisted_batch_cap(index: Index, n_probes: int, lut_dtype: str
                      ) -> Optional[int]:
    """Query-batch cap (a power of two) bounding the compressed-LUT
    pipeline's per-batch transients to ~128 MiB, or None when the config
    builds no per-(query, probe) tables (float32 LUT, inner product):
    ~3 f32 copies with an n_probes axis plus the xs gather over the
    expanded physical budget in the LUT type.  Shared by :func:`search`'s
    query batching and the serving engine's super-batch clamp."""
    if index.metric == DistanceType.InnerProduct or lut_dtype == "float32":
        return None
    n_phys = index.list_codes.shape[0] - 1
    budget = min(n_probes * index.chunk_table.shape[1],
                 n_probes + max(0, n_phys - index.n_lists))
    cell = index.pq_dim * (1 << index.pq_bits)
    per_q = cell * (3 * n_probes * 4
                    + budget * _LUT_DTYPES[lut_dtype].itemsize)
    return 1 << max(5, ((128 << 20) // max(per_q, 1)).bit_length() - 1)


def check_search_params(params: SearchParams) -> None:
    expects(params.lut_dtype in _LUT_DTYPES,
            f"lut_dtype must be one of {list(_LUT_DTYPES)}")
    expects(params.internal_distance_dtype == "float32",
            f"ivf_pq: internal_distance_dtype="
            f"{params.internal_distance_dtype!r} {_NOT_PORTED}")
    expects(params.hoisted_lut is None or bool(params.hoisted_lut),
            f"ivf_pq: the non-hoisted search (hoisted_lut=False) "
            f"{_NOT_PORTED}")


def search(params: SearchParams, index: Index, queries, k: int, *,
           batch_size_query: int = 1024, engine: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search (reference ``ivf_pq::search``): returns (distances (nq, k)
    f32, PQ-approximate, indices (nq, k) int32) on the index's device.
    Queries must have the index's dataset dtype or float32.  ``engine``
    picks kernels B2 and B4 (``"cuda"``) or their plain versions
    (``"torch"``); the default follows the device.  The tail batch is
    padded to the power-of-two bucket ladder."""
    check_search_params(params)
    q, q_dtype = _ingest_dataset(queries, index.device)
    expects(q_dtype in (index.dataset_dtype, "float32"),
            f"query dtype {q_dtype} != index dataset dtype "
            f"{index.dataset_dtype}")
    expects(q.ndim == 2 and q.shape[1] == index.dim, "query dim mismatch")
    expects(k >= 1, "k must be >= 1")
    if q.shape[0] == 0:
        return empty_result(0, int(k), torch.float32, index.device)
    n_probes = min(params.n_probes, index.n_lists)
    cap = hoisted_batch_cap(index, n_probes, params.lut_dtype)
    if cap is not None:
        batch_size_query = min(batch_size_query, cap)
    engines = _resolve_engines(index, engine)
    out_d, out_i = [], []
    for q0 in range(0, q.shape[0], batch_size_query):
        qb = q[q0:q0 + batch_size_query]
        n_valid = qb.shape[0]
        bucket = min(bucket_dim(n_valid), batch_size_query)
        if bucket != n_valid:
            qb = torch.cat([qb, qb.new_zeros((bucket - n_valid, qb.shape[1]))])
        d, i = _full_search_impl(qb, index, int(k), int(n_probes),
                                 params.lut_dtype, engines)
        out_d.append(d[:n_valid])
        out_i.append(i[:n_valid])
    if len(out_d) == 1:
        return out_d[0], out_i[0]
    return torch.cat(out_d), torch.cat(out_i)
