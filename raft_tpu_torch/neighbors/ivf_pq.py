"""IVF-PQ approximate nearest-neighbour index (port of
``raft_tpu/neighbors/ivf_pq.py``; reference neighbors/ivf_pq.cuh).

Two-level quantization ``y ≈ Q1(y) + Q2(y − Q1(y))``: coarse balanced
k-means centres (kernels B3 and B1 on the card) plus product-quantized,
rotated residuals, bit-packed LSB-first at pq_bits (4–8) bits a code in
chunked padded lists (``_build.pack_device``; ``extend`` appends into
a non-empty index through ``_build.extend_device``, encoding only the new
rows).

Build: coarse quantizer → list assignment → rotation (the PCA-balanced
one by default, a QR of a Gaussian otherwise) → the codebooks, trained by
Lloyd k-means whose every E-step is kernel B3: one per subspace
(PER_SUBSPACE, (pq_dim, 2^bits, ds)) or one per list (PER_CLUSTER,
(n_lists, 2^bits, ds), each on a fixed-size sample of its list's
subvectors; all lists in one batched launch per iteration) → encode in
row tiles of 8,192 (``_build.run_tiles``) → pack, with the build-time
list-side ADC tables ``list_adc`` and its per-candidate contraction
``list_csum``.

Search, per query batch (the hoisted-ADC path): coarse GEMM → top-n_probes
(kernel B2) → one per-batch LUT stage → the probe scan, whose every step
scores each query's probed row with kernel B4 (``kernels.ivf_pq_lut``,
codes read in place) and keeps the best k (kernel B2).  With the float32
LUT and PER_SUBSPACE codebooks the LUT is probe-invariant (the list-side
term enters per candidate through ``list_csum``); PER_CLUSTER codebooks
give a table per (query, probe), and a compressed LUT (bfloat16, float16,
float8 e4m3) is the per-probe combined table, quantized with one affine
per query; per-probe tables are threaded through the scan by each step's
probe ordinal.  ``hoisted_lut=False`` runs the legacy search instead: the
LUT is rebuilt at every scan step from the query's residual against the
probed list's centre and scored by kernel B4's raw mode.
``internal_distance_dtype="float16"`` sums the looked-up terms in float16
as the JAX package's XLA route does (rounded once after a float32 sum on
the hoisted path, sequentially on the legacy path; fp8 LUTs always sum
in float32).

A query's result bits do not depend on the batch it rides in (the serving
contract): the rotation and the coarse products run in the fixed
1,024-row blocks of ``distance.pairwise._dot_fixed_rows`` and the
query-cross LUT is a broadcast multiply and sum over the subspace width,
not a batched GEMM.

A tombstone bitmap (``tombstones=``, the mutable index's deletes) is
read inside the scan: by kernel B4's scan mode, so a dead row never
enters a step's best ``kk``, and by ``_common.scan_probe_lists`` on the
per-step path.

``build_sharded`` trains once and packs each rank's list shard of an
``ann_mnmg.ShardedIndex`` directly; ``Index.shard(comms)`` partitions a
built index.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import telemetry
from raft_tpu_torch.analysis.registry import audit_program
from raft_tpu_torch.cluster.kmeans import (centroids_from_sums,
                                           fused_em_step_batched)
from raft_tpu_torch.cluster.kmeans_balanced import build_hierarchical
from raft_tpu_torch.core.aot import aot
from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import (auto_sync_handle, device_of,
                                       resolve_device)
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import _dot_fixed_rows
from raft_tpu_torch.kernels import ivf_pq_lut
from raft_tpu_torch.kernels.engine import resolve_engine
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors._build import (DEFAULT_TILE_ROWS,
                                             extend_device, pack_device,
                                             run_tiles)
from raft_tpu_torch.neighbors._common import (_SCAN_STACK_MIN_K,
                                              empty_result, expand_probes,
                                              new_ids_of, scan_probe_lists,
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
#: rows of the residual sample the PCA-balanced rotation is fitted on
_PCA_SAMPLE = 50_000
#: the sum's type of each ``internal_distance_dtype`` on the hoisted and
#: on the legacy path (kernel B4's ``acc``)
_INTERNAL_DTYPES = {
    "float32": (ivf_pq_lut.SUM_FLOAT32, ivf_pq_lut.SUM_FLOAT32),
    "float16": (ivf_pq_lut.SUM_HALF_ONCE, ivf_pq_lut.SUM_HALF_SEQUENTIAL)}


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
    internal_distance_dtype: str = "float32"   # float32 | float16
    # None or True: the hoisted search; False: the legacy search
    hoisted_lut: Optional[bool] = None
    # exact re-rank ratio of the tiered searcher (neighbors.tiering): the
    # scan keeps k·ratio candidates, re-scored from the original vectors
    refine_ratio: Optional[int] = None


@dataclasses.dataclass
class Index:
    """IVF-PQ index (the JAX ``Index`` leaves):

    ``centers``      (n_lists, dim) f32 coarse centroids
    ``rotation``     (dim, rot_dim) f32 orthonormal transform
    ``codebooks``    (pq_dim, 2^bits, ds) f32 (PER_SUBSPACE) or
                     (n_lists, 2^bits, ds) (PER_CLUSTER), ds = rot_dim // pq_dim
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
    def rot_dim(self) -> int:
        return self.rotation.shape[1]

    @property
    def per_cluster(self) -> bool:
        return self.codebook_kind == CodebookKind.PER_CLUSTER

    @property
    def pq_dim(self) -> int:
        if self.per_cluster:
            return self.rot_dim // self.codebooks.shape[2]
        return self.codebooks.shape[0]

    @property
    def pq_len(self) -> int:
        """Rotated dimensions per PQ subspace (rot_dim // pq_dim)."""
        return self.codebooks.shape[2]

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

    def shard(self, comms):
        """This rank's round-robin list shard of the index across *comms*'
        ranks (``ann_mnmg.shard_ivf_pq``)."""
        from raft_tpu_torch.neighbors import ann_mnmg

        return ann_mnmg.shard_ivf_pq(self, comms)


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
    # exempt(dtype-drift): host covariance of the PCA rotation (numpy)
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


def _cluster_sample_take(counts: np.ndarray, cap: int,
                         rng_fill: np.random.Generator) -> np.ndarray:
    """Per-(list, slot) position in the list's permuted pool, before the
    wrap modulo the pool size (the JAX package's numpy code): slot j below
    the pool's size keeps j, so a pool at or above the cap enters whole
    and without repeats; the slots past a smaller pool's size are drawn
    from the independent *rng_fill* stream, one draw per slot."""
    n_lists = counts.shape[0]
    j = np.arange(cap)
    take = np.broadcast_to(j[None, :], (n_lists, cap)).copy()
    excess = j[None, :] >= counts[:, None]
    if excess.any():
        take[excess] = rng_fill.integers(0, 1 << 62,
                                         size=int(excess.sum()))
    return take


def _train_codebooks_cluster(gen: torch.Generator, residuals: torch.Tensor,
                             labels: torch.Tensor, n_lists: int, pq_dim: int,
                             k: int, iters: int, engine: Optional[str]
                             ) -> torch.Tensor:
    """PER_CLUSTER: one codebook per list, (n_lists, k, ds).  Every row
    gives its pq_dim subvectors to its list's pool; each pool is shuffled
    on the device (a random key, then a stable sort by list) and a list
    trains on the first ``cap`` = max(4k, 256) of its pool, a smaller pool
    filling the rest from an independent host stream
    (:func:`_cluster_sample_take`); an empty list's sample is zero.  Then
    all n_lists codebooks train together (:func:`_lloyd_kmeans`: kernel
    B3's batched mode on the card, one launch per iteration).  The JAX
    package seeds its draws from its key; the port from *gen*."""
    n, rot_dim = residuals.shape
    dev = residuals.device
    ds = rot_dim // pq_dim
    cap = max(k * 4, 256)
    seed0 = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen))
    rng_fill = np.random.default_rng(seed0 + 0x9E3779B9)
    sub = residuals.reshape(n * pq_dim, ds)
    lab = labels.long().repeat_interleave(pq_dim)
    keys = torch.rand(lab.shape[0], generator=torch.Generator().manual_seed(
        seed0)).to(dev)
    perm = torch.argsort(keys, stable=True)
    shuf = perm[torch.argsort(lab[perm], stable=True)]
    counts = torch.bincount(lab, minlength=n_lists).cpu().numpy()
    starts = np.zeros(n_lists + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    take = _cluster_sample_take(counts, cap, rng_fill)
    gather = starts[:n_lists, None] + take % np.maximum(counts, 1)[:, None]
    gather = torch.as_tensor(np.minimum(gather, max(lab.shape[0] - 1, 0)),
                             device=dev)
    batches = sub[shuf[gather]]
    batches[torch.as_tensor(counts == 0, device=dev)] = 0.0
    return _lloyd_kmeans(gen, batches, k, iters, engine)


def _encode(residuals: torch.Tensor, codebooks: torch.Tensor,
            labels: Optional[torch.Tensor] = None,
            per_cluster: bool = False) -> torch.Tensor:
    """PQ-encode rotated residuals → (n, pq_dim) uint8: per subspace the
    nearest codeword by ‖sub‖² + ‖cb‖² − 2·sub·cb (PER_CLUSTER: of the
    row's list's codebook, ``codebooks[labels]``), the earlier codeword
    winning ties (``torch.argmin`` returns the first minimum)."""
    n, rot_dim = residuals.shape
    ds = codebooks.shape[2]
    pq_dim = rot_dim // ds
    sub = residuals.reshape(n, pq_dim, ds)
    if per_cluster:
        cb = codebooks[labels.long()]                       # (n, kcb, ds)
        cb_sq = torch.sum(cb * cb, -1)[:, None, :]
        cross = _sub_dot(sub[:, :, None, :], cb[:, None, :, :])
    else:
        cb_sq = torch.sum(codebooks * codebooks, -1)[None, :, :]
        cross = _sub_dot(sub[:, :, None, :], codebooks[None])
    d = torch.sum(sub * sub, -1)[:, :, None] + cb_sq - 2.0 * cross
    return torch.argmin(d, dim=-1).to(torch.uint8)


def _build_list_adc(rot_centers: torch.Tensor, codebooks: torch.Tensor,
                    per_cluster: bool = False) -> torch.Tensor:
    """Build-time list-side ADC table (n_lists, pq_dim, 2^bits) f32:
    ``list_adc[l, m, k] = ‖cb[m, k]‖² + 2·ctr_rot[l, m]·cb[m, k]``, the
    codebook list l's own under PER_CLUSTER."""
    ds = codebooks.shape[2]
    ctr = rot_centers.reshape(rot_centers.shape[0], -1, ds)
    cb_sq = torch.sum(codebooks * codebooks, -1)
    if per_cluster:                                       # cb_sq (L, kcb)
        return cb_sq[:, None, :] + 2.0 * _sub_dot(ctr[:, :, None, :],
                                                  codebooks[:, None])
    return cb_sq[None] + 2.0 * _sub_dot(ctr[:, :, None, :], codebooks[None])


@audit_program(
    "ivf_pq.csum_tile", transient_bytes=8 << 20,
    notes="the per-candidate list-side ADC sums of one 8,192-row tile")
def _csum_for_codes(codes: torch.Tensor, labels: torch.Tensor,
                    rot_centers: torch.Tensor, codebooks: torch.Tensor,
                    per_cluster: bool = False) -> torch.Tensor:
    """Per candidate Σ_m list_adc[label, m, code_m] = ‖decoded‖² +
    2·ctr_rot[label]·decoded, through the decoded rotated residual."""
    n, pq_dim = codes.shape
    if per_cluster:
        dec = codebooks[labels.long()[:, None], codes.long()]
    else:
        m = torch.arange(pq_dim, device=codes.device)
        dec = codebooks[m[None, :], codes.long()]
    dec = dec.reshape(n, -1)                                # (n, rot_dim)
    ctr = rot_centers[labels.long()]
    return torch.sum(dec * dec, -1) + 2.0 * torch.sum(ctr * dec, -1)


def _csum_for_packed(list_codes: torch.Tensor, owner: torch.Tensor,
                     rot_centers: torch.Tensor, codebooks: torch.Tensor,
                     pq_bits: int, tile_phys: int = 1024,
                     per_cluster: bool = False) -> torch.Tensor:
    """``list_csum`` of an already packed code block (a v1 archive),
    unpacked ``tile_phys`` physical rows at a time; padding slots get
    values that the live-slot mask discards."""
    rows, cap = list_codes.shape[0], list_codes.shape[1]
    pq_dim = rot_centers.shape[1] // codebooks.shape[2]
    out = []
    for r0 in range(0, rows, tile_phys):
        r1 = min(r0 + tile_phys, rows)
        codes = _unpack_codes(list_codes[r0:r1].reshape((r1 - r0) * cap, -1),
                              pq_dim, pq_bits)
        labels = torch.repeat_interleave(owner[r0:r1], cap)
        out.append(_csum_tile_aot(codes, labels, rot_centers, codebooks,
                                  per_cluster).reshape(r1 - r0, cap))
    return torch.cat(out) if out else rot_centers.new_zeros((0, cap))


def _validate_build(params: IndexParams, x: torch.Tensor) -> None:
    expects(x.ndim == 2, "dataset must be (n, dim)")
    expects(params.metric in _SUPPORTED,
            f"ivf_pq: unsupported metric {params.metric}")
    expects(4 <= params.pq_bits <= 8,
            "pq_bits must be in [4, 8] (ivf_pq_types.hpp:52)")
    expects(params.rotation_kind in ("auto", "default", "pca_balanced"),
            f"unknown rotation_kind {params.rotation_kind!r}")
    expects(int(params.codebook_kind) in set(CodebookKind),
            f"unknown codebook_kind {params.codebook_kind!r}")


def _sample_rows(n: int, size: int, seed: int) -> np.ndarray:
    return np.sort(np.random.default_rng(seed).choice(n, size=size,
                                                      replace=False))


def _train_model(params: IndexParams, x: torch.Tensor,
                 engine: Optional[str]):
    """Coarse quantizer and assignment (span ``build.train``), rotation
    and codebooks (``build.codebooks``).  Returns (centers, labels,
    rotation, codebooks)."""
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

    with telemetry.span("build.train"):
        train = subsample_trainset(x, params.kmeans_trainset_fraction,
                                   n_lists, params.seed)
        centers = build_hierarchical(RngState(params.seed), train, n_lists,
                                     params.kmeans_n_iters, engine=engine)
        del train
        # the lists must agree with how search ranks probes: max-dot for
        # inner product, else min-L2 (kernel B1)
        labels = _assign_lists(x, centers, params.metric, engine)

    with telemetry.span("build.codebooks"):
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
            sel_t = torch.as_tensor(_sample_rows(n, cap_t,
                                                 params.seed + 13),
                                    device=dev)
            x_t, lab_t = x[sel_t], labels[sel_t]
        else:
            x_t, lab_t = x, labels
        resid_t = (x_t - centers[lab_t.long()]) @ rotation
        if CodebookKind(int(params.codebook_kind)) == \
                CodebookKind.PER_CLUSTER:
            codebooks = _train_codebooks_cluster(
                rng.next_generator(), resid_t, lab_t, n_lists, pq_dim, k,
                params.kmeans_n_iters, engine)
        else:
            codebooks = _train_codebooks_subspace(
                rng.next_generator(), resid_t, pq_dim, k,
                params.kmeans_n_iters, engine)
    return centers, labels, rotation, codebooks


@audit_program(
    "ivf_pq.encode_tile",
    # the eager encode holds (tile, pq_dim, 2^bits) f32 distance planes —
    # 64 MB each at 8,192 × 8 × 256 — four of them live at its peak (the
    # cross product, the distances and two broadcast sums; 257 MB on an
    # H100), where the JAX package's fused encode holds 4.2 MB a tile;
    # five planes bound it, and a regression to a (tile, pq_dim, 2^bits,
    # ds) product (1 GB here) fails
    transient_bytes=5 * (8192 * 8 * 256 * 4),
    notes="one 8,192-row populate tile: residual, rotation, encode, pack "
          "and the list-side sums")
def _encode_tile(index: Index, xt: torch.Tensor, lt: torch.Tensor,
                 keep: Optional[torch.Tensor] = None):
    """(packed codes, csum) of one row tile under *index*'s model:
    residual → rotate → encode → pack, and the per-candidate list-side
    sum.  With *keep* only those rows are encoded; the rotation product
    still runs on the whole tile, so a row's bits do not depend on which
    rows of its tile are kept."""
    lt = lt.long()
    rot = (xt - index.centers[lt]) @ index.rotation
    if keep is not None:
        rot, lt = rot[keep], lt[keep]
    codes = _encode(rot, index.codebooks, lt, index.per_cluster)
    return (_pack_codes(codes, index.pq_bits),
            _csum_for_codes(codes, lt, index.rot_centers, index.codebooks,
                            index.per_cluster))


def _encode_rows(index: Index, x: torch.Tensor, labels: torch.Tensor,
                 tile_rows: Optional[int] = None):
    """(packed codes, csum) of *x*'s rows under *index*'s model, in row
    tiles of *tile_rows* (``_build.run_tiles``)."""
    if x.shape[0] == 0:
        return (torch.zeros((0, _code_bytes(index.pq_dim, index.pq_bits)),
                            dtype=torch.uint8, device=x.device),
                torch.zeros(0, device=x.device))
    return run_tiles(lambda xt, lt: _encode_tile_aot(index, xt, lt), x,
                     labels, tile_rows)


#: the populate tile and the list-side sums of packed codes, keyed per
#: signature (``raft_tpu/neighbors/ivf_pq.py:797,801`` ``_encode_tile_aot``
#: / ``_csum_tile_aot``).  The reference runs the csum as its own program
#: so XLA's fusion cannot move its last bit; eager PyTorch fuses nothing,
#: so the populate tile computes both (the same bits), and the csum
#: program is what an archive without sums rebuilds them with
#: (:func:`_csum_for_packed`)
_encode_tile_aot = aot(_encode_tile)
_csum_tile_aot = aot(_csum_for_codes, static_argnums=(4,))


def _empty_index(centers, rotation, codebooks, metric, pq_bits: int,
                 dataset_dtype: str,
                 codebook_kind=CodebookKind.PER_SUBSPACE) -> Index:
    dev = centers.device
    n_lists = centers.shape[0]
    per_cluster = CodebookKind(int(codebook_kind)) == CodebookKind.PER_CLUSTER
    nbytes = _code_bytes(rotation.shape[1] // codebooks.shape[2], pq_bits)
    return Index(
        centers=centers, rotation=rotation, codebooks=codebooks,
        list_codes=torch.zeros((1, 8, nbytes), dtype=torch.uint8, device=dev),
        list_indices=torch.full((1, 8), -1, dtype=torch.int32, device=dev),
        list_sizes=torch.zeros(n_lists, dtype=torch.int32, device=dev),
        phys_sizes=torch.zeros(1, dtype=torch.int32, device=dev),
        chunk_table=torch.zeros((n_lists, 1), dtype=torch.int32, device=dev),
        owner=torch.zeros(1, dtype=torch.int32, device=dev),
        list_adc=_build_list_adc(centers @ rotation, codebooks, per_cluster),
        list_csum=torch.zeros((1, 8), device=dev), metric=metric,
        codebook_kind=CodebookKind(int(codebook_kind)), pq_bits=pq_bits,
        dataset_dtype=dataset_dtype)


@auto_sync_handle
def build(params: IndexParams, dataset, ids=None, *,
          tile_rows: Optional[int] = None, handle=None, device=None,
          engine: Optional[str] = None) -> Index:
    """Train and populate an IVF-PQ index (reference ``ivf_pq::build``).
    *dataset* is an (n, dim) float32, int8 or uint8 array or tensor;
    ``device=None`` runs on the card.  ``engine`` picks the kernels
    (``"cuda"``) or their plain versions (``"torch"``) for the E-steps.
    *tile_rows* bounds the populate's row tile (default
    ``DEFAULT_TILE_ROWS``; the index is the same bits at any tile);
    *handle* as ``pairwise_distance``'s."""
    dev = device_of(handle, device)
    x, dataset_dtype = _ingest_dataset(dataset, dev)
    _validate_build(params, x)
    centers, labels, rotation, codebooks = _train_model(params, x, engine)
    index = _empty_index(centers, rotation, codebooks, params.metric,
                         params.pq_bits, dataset_dtype, params.codebook_kind)
    if params.add_data_on_build:
        return _populate(index, x, ids, labels, tile_rows=tile_rows)
    expects(ids is None, "ids were passed but add_data_on_build=False "
            "stores no rows — pass them to extend() instead")
    return index


def _populate(index: Index, x: torch.Tensor, ids, labels: torch.Tensor,
              in_place: bool = False, ladder: bool = False,
              tile_rows: Optional[int] = None) -> Index:
    """Encode *x*'s rows under *index*'s model (span ``build.encode``) and
    pack them into its lists (``build.populate``): a fresh pack when the
    index is empty, else an append."""
    base = index.size
    ids = new_ids_of(index, ids, x.shape[0])
    with telemetry.span("build.encode"):
        packed, csum = _encode_rows(index, x, labels, tile_rows)
    with telemetry.span("build.populate"):
        if base:
            ((list_codes, list_csum), list_indices, phys_sizes, list_sizes,
             chunk_table, owner) = extend_device(
                (index.list_codes, index.list_csum), index.list_indices,
                index.list_sizes, index.chunk_table, (packed, csum), ids,
                labels, in_place=in_place, ladder=ladder)
        else:
            ((list_codes, list_csum), list_indices, phys_sizes, list_sizes,
             chunk_table, owner) = pack_device((packed, csum), ids, labels,
                                               index.n_lists, ladder)
    # the trained model is untouched, so the list-side ADC table carries
    # over as it is
    return Index(centers=index.centers, rotation=index.rotation,
                 codebooks=index.codebooks, list_codes=list_codes,
                 list_indices=list_indices, list_sizes=list_sizes,
                 phys_sizes=phys_sizes, chunk_table=chunk_table, owner=owner,
                 list_adc=index.list_adc, list_csum=list_csum,
                 metric=index.metric, codebook_kind=index.codebook_kind,
                 pq_bits=index.pq_bits, dataset_dtype=index.dataset_dtype)


def extend(index: Index, new_vectors, new_ids=None, *,
           tile_rows: Optional[int] = None, engine: Optional[str] = None,
           in_place: bool = False, ladder: bool = False) -> Index:
    """Add vectors to the index (reference ``ivf_pq::extend``): assign
    (kernel B1 on the card for L2), encode with the trained model — no
    retraining — and append the codes and their ``list_csum`` into each
    list's free tail slots; only lists that overflow grow a chunk.
    Returns a new :class:`Index`; with ``in_place`` and no list
    overflowing, its blocks are *index*'s own, written in place (O(n_new)).
    *new_ids* default to ``size, size + 1, …``; given ones must be new
    (``ValueError`` otherwise, as ``ivf_flat.extend``); *ladder* as
    ``ivf_flat.extend``'s; *tile_rows* as :func:`build`'s."""
    x, new_dtype = _ingest_dataset(new_vectors, index.device)
    expects(new_dtype == index.dataset_dtype,
            f"extend dtype {new_dtype} != index dataset dtype "
            f"{index.dataset_dtype}")
    expects(x.ndim == 2 and x.shape[1] == index.dim, "dim mismatch")
    labels = _assign_lists(x, index.centers, index.metric, engine)
    return _populate(index, x, new_ids, labels, in_place=in_place,
                     ladder=ladder, tile_rows=tile_rows)


def build_sharded(params: IndexParams, dataset, comms, ids=None, *,
                  tile_rows: Optional[int] = None, device=None,
                  engine: Optional[str] = None):
    """Train once and populate straight into list shards (the JAX
    package's ``build_sharded``): the communicator's first rank trains the
    model (coarse centres, rotation, codebooks) and assigns every row its
    list, all broadcast; then each rank encodes and packs ONLY the rows of
    its round-robin list shard, in the row tiles of :func:`build`.  The
    result is an ``ann_mnmg.ShardedIndex``, bit for bit ``build(params,
    dataset).shard(comms)`` on the same device and engine, without the
    full packed index on any rank.  Every rank passes the same
    *dataset*; *tile_rows* as :func:`build`'s."""
    from raft_tpu_torch.neighbors import ann_mnmg

    comms = ann_mnmg._full_axis_comms(comms)
    dev = resolve_device(device)
    x, dataset_dtype = _ingest_dataset(dataset, dev)
    _validate_build(params, x)
    expects(params.add_data_on_build,
            "build_sharded populates by construction — use "
            "build(add_data_on_build=False) + extend + shard() for "
            "deferred ingest")
    n, dim = x.shape
    n_lists = min(params.n_lists, n)
    pq_dim = params.pq_dim or _calc_pq_dim(dim)
    rot_dim = -(-dim // pq_dim) * pq_dim
    per_cluster = (CodebookKind(int(params.codebook_kind))
                   == CodebookKind.PER_CLUSTER)
    specs = [((n_lists, dim), torch.float32, dev),
             ((n,), torch.int32, dev),
             ((dim, rot_dim), torch.float32, dev),
             ((n_lists if per_cluster else pq_dim, 1 << params.pq_bits,
               rot_dim // pq_dim), torch.float32, dev)]
    centers, labels, rotation, codebooks = ann_mnmg.train_on_first(
        comms, specs, lambda: _train_model(params, x, engine))
    model = _empty_index(centers, rotation, codebooks, params.metric,
                         params.pq_bits, dataset_dtype, params.codebook_kind)
    ids = (torch.arange(n, dtype=torch.int32, device=dev) if ids is None
           else torch.as_tensor(ids, device=dev).to(torch.int32))
    expects(ids.shape == (n,), "ids must be (n,)")
    keep = labels.long() % comms.get_size() == comms.get_rank()
    tile = max(8, min(int(tile_rows or DEFAULT_TILE_ROWS), n))
    parts = [_encode_tile_aot(model, x[t0:t0 + tile], labels[t0:t0 + tile],
                              keep[t0:t0 + tile])
             for t0 in range(0, n, tile)]
    packed = torch.cat([p for p, _ in parts])
    csum = torch.cat([c for _, c in parts])
    ((codes, list_csum), idx, psz, table, owner, probe_extra,
     max_chunks) = ann_mnmg.populate_shard(
        comms, labels, n_lists, (packed, csum), ids,
        torch.nonzero(keep).flatten())
    aux = ann_mnmg._ivf_pq_aux(
        comms.get_size(), int(dim), int(params.metric), n_lists,
        probe_extra, int(params.pq_bits), int(params.codebook_kind),
        dataset_dtype, int(model.pq_dim), max_chunks)
    return ann_mnmg.ShardedIndex(
        "ivf_pq", comms, (centers, rotation, codebooks, model.list_adc),
        (codes, idx, psz, table, owner, list_csum), aux)


def index_from_arrays(arrays: Dict[str, np.ndarray], metric,
                      codebook_kind=CodebookKind.PER_SUBSPACE,
                      pq_bits: int = 8, dataset_dtype: str = "float32",
                      device=None) -> Index:
    """An :class:`Index` from the JAX ``Index`` leaves as numpy arrays under
    their field names (:data:`ARRAY_FIELDS`) — e.g. an index the JAX
    package built."""
    dev = resolve_device(device)
    vals = {}
    for name in ARRAY_FIELDS:
        dt = (np.float32 if name in _FLOAT_FIELDS
              else np.uint8 if name == "list_codes" else np.int32)
        vals[name] = torch.as_tensor(np.array(arrays[name], dt), device=dev)
    return Index(**vals, metric=DistanceType(int(metric)),
                 codebook_kind=CodebookKind(int(codebook_kind)),
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


class ScanInputs(NamedTuple):
    """What the probe scan of one query batch reads besides the index:
    each query's physical rows (nq, S), its LUT (nq, F) or per-probe LUTs
    (nq, P, F) with each step's slice ``ords`` (nq, S), the exact f32
    base per (query, step), and the epilogue's optional terms."""

    phys: torch.Tensor
    tables: torch.Tensor
    ords: Optional[torch.Tensor]
    base: torch.Tensor
    csum: Optional[torch.Tensor]
    scale: Optional[torch.Tensor]


def scan_inputs(q: torch.Tensor, probe_ids: torch.Tensor,
                rot_q: torch.Tensor, index: Index, lut_dtype_name: str,
                extra: Optional[int] = None) -> ScanInputs:
    """The hoisted-ADC LUT stage of one batch.

    PER_SUBSPACE, float32 LUT (or IP): the query-cross LUT is
    probe-invariant, (nq, pq_dim·kcb); the list-side term enters per
    candidate through ``list_csum``.  PER_CLUSTER: the query-cross table
    of each (query, probe) against the probed list's codebook
    (``qmd,qpkd->qpmk``), ``list_csum`` still added at the float32 LUT.
    Compressed LUT (L2): the per-probe combined table
    ``list_adc[probe] − 2·rot_q·cb``, quantized with one affine per query,
    one slice per probe.  ‖r‖² (L2) or q·c (IP) rides the exact f32
    per-(query, probe) base.  *extra* bounds the scan's steps as
    ``expand_probes`` does (None: the block's continuation chunks)."""
    nq = q.shape[0]
    kcb, ds = index.codebooks.shape[1], index.codebooks.shape[2]
    pq_dim = index.pq_dim
    is_ip = index.metric == DistanceType.InnerProduct
    q_sub = rot_q.reshape(nq, pq_dim, ds)
    combine = (not is_ip) and lut_dtype_name != "float32"
    if index.per_cluster:
        cbp = index.codebooks[probe_ids.long()]           # (nq, P, kcb, ds)
        qlut = _sub_dot(q_sub[:, None, :, None, :], cbp[:, :, None, :, :])
    else:
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
                                    index.list_codes.shape[0], extra=extra,
                                    return_ord=True)
    per_probe = lut_q.shape[1] > 1     # PER_CLUSTER's or the combined tables
    return ScanInputs(
        phys=phys, tables=lut_q if per_probe else lut_q[:, 0],
        ords=probe_ord if per_probe else None,
        base=torch.gather(base, 1, probe_ord),
        csum=index.list_csum if not is_ip and not combine else None,
        scale=scale if lut_dtype_name == "float8_e4m3" else None)


def _scan_steps(inp: ScanInputs, index: Index, k: int, select_min: bool,
                lut_engine: str, tombstones: Optional[torch.Tensor] = None,
                *, acc: int = ivf_pq_lut.SUM_FLOAT32):
    """The hoisted-ADC probe scan in kernel B4's scan mode (or its plain
    twin): one launch for the batch, each step's best ``min(k, cap)`` as
    (values, slots), each (nq, S, kk); :func:`_select_scanned` keeps the
    best k of them.  Only for ``k <= MAX_K`` (kernel B2's limit): wider k
    takes the per-step path (:func:`_scan_per_step`), which gives the same
    result in the same tie order.  Rows whose id is set in *tombstones*
    are dead inside the scan; *acc* types the lookup's sum
    (``ivf_pq_lut``)."""
    kcb = index.codebooks.shape[1]
    scan = (ivf_pq_lut.lut_scan_topk if lut_engine == "cuda"
            else ivf_pq_lut.lut_scan_topk_plain)
    mask = () if tombstones is None else (index.list_indices, tombstones)
    return scan(index.list_codes, inp.phys, index.phys_sizes, inp.tables,
                inp.ords, inp.base, inp.csum, inp.scale, index.pq_dim,
                index.pq_bits, kcb, min(k, index.capacity), select_min,
                *mask, acc=acc)


def _lookup(index: Index, rows: torch.Tensor, lut: torch.Tensor,
            lut_engine: str, acc: int) -> torch.Tensor:
    """Raw B4 scores (nq, cap) of each query's row against its LUT (the
    kernel's raw mode, or its plain version)."""
    kcb = index.codebooks.shape[1]
    if lut_engine == "cuda":
        return ivf_pq_lut.lut_score_rows(index.list_codes, rows, lut,
                                         index.pq_dim, index.pq_bits, kcb,
                                         acc)
    return ivf_pq_lut._lut_score_plain(index.list_codes[rows.long()], lut,
                                       index.pq_dim, index.pq_bits, kcb, acc)


def _scan_per_step(inp: ScanInputs, index: Index, k: int, select_min: bool,
                   engine: str, lut_engine: str,
                   tombstones: Optional[torch.Tensor] = None, *,
                   acc: int = ivf_pq_lut.SUM_FLOAT32):
    """The probe scan step by step: raw B4 scores of every query's row
    (or their plain version), the epilogue, the live mask, a select per
    step and the running merge."""

    def score_tile(rows, s):
        lut_t = ivf_pq_lut._lut_slice(inp.tables, inp.ords, s)
        raw = _lookup(index, rows, lut_t, lut_engine, acc)
        d = raw if inp.scale is None else raw / inp.scale[:, None]
        d = d + inp.base[:, s, None]
        return d + inp.csum[rows.long()] if inp.csum is not None else d

    return scan_probe_lists(inp.phys, score_tile, index.list_indices,
                            index.phys_sizes, k, select_min=select_min,
                            dtype=torch.float32, engine=engine,
                            xs=(range(inp.phys.shape[1]),),
                            tombstones=tombstones)


def _scan_legacy(q: torch.Tensor, probe_ids: torch.Tensor,
                 rot_q: torch.Tensor, index: Index, k: int,
                 lut_dtype_name: str, engine: str, lut_engine: str,
                 tombstones: Optional[torch.Tensor] = None, *,
                 acc: int = ivf_pq_lut.SUM_FLOAT32,
                 extra: Optional[int] = None):
    """The legacy search (``hoisted_lut=False``, the JAX package's
    ``score_tile``): at every scan step the LUT of each query is rebuilt
    against the probed row's list — L2: ‖r‖² + ‖cb‖² − 2·r·cb of the
    query's residual r against the list's centre; IP: rot_q·cb, with q·c
    as the step's base — an fp8 LUT quantized with an affine per (query,
    step); then kernel B4's raw mode (or its plain version), summed as
    *acc* says, and the per-step select and running merge."""
    nq = q.shape[0]
    kcb, ds = index.codebooks.shape[1], index.codebooks.shape[2]
    pq_dim = index.pq_dim
    is_ip = index.metric == DistanceType.InnerProduct
    is_fp8 = lut_dtype_name == "float8_e4m3"
    lut_type = _LUT_DTYPES[lut_dtype_name]
    phys = expand_probes(probe_ids, index.chunk_table,
                         index.list_codes.shape[0], extra=extra)
    if not index.per_cluster:
        cb_sq_all = torch.sum(index.codebooks * index.codebooks, -1)[None]

    def score_tile(rows):
        lists = index.owner[rows.long()].long()
        cb = (index.codebooks[lists] if index.per_cluster
              else index.codebooks[None])           # (nq or 1, …, kcb, ds)
        cb = cb[:, None] if index.per_cluster else cb
        if is_ip:
            lut = _sub_dot(rot_q.reshape(nq, pq_dim, 1, ds), cb)
            base = torch.sum(q * index.centers[lists], -1)
        else:
            r = (rot_q - index.rot_centers[lists]).reshape(nq, pq_dim, ds)
            cb_sq = (torch.sum(cb * cb, -1) if index.per_cluster
                     else cb_sq_all)
            lut = (torch.sum(r * r, -1)[:, :, None] + cb_sq
                   - 2.0 * _sub_dot(r[:, :, None, :], cb))
            base = torch.zeros(nq, dtype=torch.float32, device=q.device)
        if is_fp8:
            lo = torch.amin(lut, dim=2, keepdim=True)
            lut0 = lut - lo
            scale = _FP8_PEAK / torch.clamp_min(torch.amax(lut0, dim=(1, 2)),
                                                1e-30)
            lut = lut0 * scale[:, None, None]
            base = base + torch.sum(lo[:, :, 0], dim=1)
        else:
            scale = torch.ones(nq, dtype=torch.float32, device=q.device)
        raw = _lookup(index, rows, lut.to(lut_type).reshape(nq, -1),
                      lut_engine, acc)
        return raw / scale[:, None] + base[:, None]

    return scan_probe_lists(phys, score_tile, index.list_indices,
                            index.phys_sizes, k, select_min=not is_ip,
                            dtype=torch.float32, engine=engine,
                            tombstones=tombstones)


def _select_scanned(vals: torch.Tensor, slots: torch.Tensor,
                    phys: torch.Tensor, list_indices: torch.Tensor, k: int,
                    select_min: bool, engine: str):
    """Best k of scan mode's per-step winners (nq, S, kk): one select over
    the steps' runs laid end to end (step-major, each best-first), so
    earlier steps, then lower slots, win ties — the running merge's order;
    ids come from ``list_indices`` for the winners only.  Fewer than k
    candidates leave the worst value and id −1.

    Below :data:`_SCAN_STACK_MIN_K` (or with fewer than k slots in all)
    the per-step path runs a running merge seeded with (sentinel, −1),
    whose seed wins ties: there a winner no better than the sentinel (a
    live candidate scoring ±inf, or NaN) becomes (sentinel, −1) too.  At
    or above it the per-step path selects over the stacked masked tiles,
    as this select does, and such a winner keeps its id.  A slot of −1
    (the fill of a step with fewer than ``kk`` candidates under a
    tombstone mask) gives id −1."""
    nq, n_steps, kk = vals.shape
    sentinel = float("inf") if select_min else float("-inf")
    flat = vals.reshape(nq, n_steps * kk)
    kt = min(k, flat.shape[1])
    best_d, pos = select_k(flat, kt, select_min, engine=engine)
    pos = pos.long()
    slot = torch.gather(slots.reshape(nq, -1), 1, pos).long()
    row = torch.gather(phys, 1, torch.div(pos, kk, rounding_mode="floor"))
    best_i = torch.where(slot >= 0,
                         list_indices[row.long(), torch.clamp_min(slot, 0)],
                         -1)
    if not (k >= _SCAN_STACK_MIN_K and n_steps * list_indices.shape[1] >= k):
        beats = best_d < sentinel if select_min else best_d > sentinel
        best_d = torch.where(beats, best_d, torch.full_like(best_d,
                                                            sentinel))
        best_i = torch.where(beats, best_i, torch.full_like(best_i, -1))
    if kt < k:
        best_d = torch.cat([best_d, torch.full(
            (nq, k - kt), sentinel, dtype=best_d.dtype,
            device=best_d.device)], dim=1)
        best_i = torch.cat([best_i, torch.full(
            (nq, k - kt), -1, dtype=best_i.dtype, device=best_i.device)],
            dim=1)
    return best_d, best_i


def _resolve_engines(index: Index,
                     engine: Optional[str]) -> Tuple[str, str]:
    """(select_k engine, pq_lut engine) for one knob: ``None`` follows the
    device, ``"cuda"`` asks for both kernels, ``"torch"`` for both plain
    versions."""
    return (resolve_engine("select_k", index.device, engine=engine),
            resolve_engine("pq_lut", index.device, engine=engine))


def _resolve_hoisted(params: SearchParams) -> bool:
    return params.hoisted_lut is None or bool(params.hoisted_lut)


def _search_batch_impl(q: torch.Tensor, probe_ids: torch.Tensor,
                       index: Index, k: int, lut_dtype_name: str,
                       engines: Tuple[str, str],
                       tombstones: Optional[torch.Tensor] = None,
                       sqrt: bool = True, *,
                       int_dtype: str = "float32", hoisted: bool = True,
                       extra: Optional[int] = None):
    """Score the probed lists of one query batch and keep the best k (the
    L2Sqrt root taken only with *sqrt*: a caller that merges squared
    distances takes it after the merge).

    Three stages, each under one span: ``ivf_pq.lut`` (the query rotation
    and, hoisted, :func:`scan_inputs`), ``ivf_pq.scan`` (B4's scan mode
    for ``k <= MAX_K``, else the per-step path; with ``hoisted=False`` the
    legacy scan) and ``ivf_pq.select`` (the select over scan mode's
    per-step winners, and the root).  *int_dtype* is the
    ``internal_distance_dtype`` (ignored by fp8 LUTs, which sum in
    float32) and *extra* the scan's step bound (``expand_probes``)."""
    from raft_tpu_torch.kernels.select_k import MAX_K

    engine, lut_engine = engines
    on_hoisted, on_legacy = _INTERNAL_DTYPES[int_dtype]
    acc = (ivf_pq_lut.SUM_FLOAT32 if lut_dtype_name == "float8_e4m3"
           else on_hoisted if hoisted else on_legacy)
    select_min = index.metric != DistanceType.InnerProduct
    with telemetry.span("ivf_pq.lut"):
        rot_q = _dot_fixed_rows(q, index.rotation.T)      # (nq, rot_dim)
        inp = (scan_inputs(q, probe_ids, rot_q, index, lut_dtype_name,
                           extra) if hoisted else None)
    steps = None
    with telemetry.span("ivf_pq.scan"):
        if not hoisted:
            best_d, best_i = _scan_legacy(
                q, probe_ids, rot_q, index, k, lut_dtype_name, engine,
                lut_engine, tombstones, acc=acc, extra=extra)
        elif k > MAX_K:
            best_d, best_i = _scan_per_step(inp, index, k, select_min,
                                            engine, lut_engine, tombstones,
                                            acc=acc)
        else:
            steps = _scan_steps(inp, index, k, select_min, lut_engine,
                                tombstones, acc=acc)
    with telemetry.span("ivf_pq.select"):
        if steps is not None:
            best_d, best_i = _select_scanned(*steps, inp.phys,
                                             index.list_indices, k,
                                             select_min, engine)
        if sqrt and index.metric == DistanceType.L2SqrtExpanded:
            best_d = torch.sqrt(torch.clamp_min(best_d, 0.0))
    return best_d, best_i


#: the probe-scoring program (coarse ranking done), keyed per signature
#: (``raft_tpu/neighbors/ivf_pq.py:1413`` ``_search_batch_aot``, the
#: hoisted and the legacy ``hoisted_lut=False`` scan): each tiered cold
#: tile dispatches it.  The eager :func:`search` keeps the whole-batch
#: :data:`_full_search_aot`, the serving engine's program, so a request
#: an engine serves solo runs the signatures its warmup ran
_search_batch_aot = aot(_search_batch_impl, static_argnums=(3, 4, 5))


def coarse_probes(queries: torch.Tensor, index: Index, n_probes: int,
                  engine: str) -> torch.Tensor:
    """Each query's n_probes nearest lists (coarse GEMM, kernel B2) — the
    ranking every serving path of the family shares; one
    ``ivf_pq.coarse`` span."""
    with telemetry.span("ivf_pq.coarse"):
        coarse = _coarse_distances(queries, index.centers, index.metric)
        _, probes = select_k(coarse, n_probes, select_min=True,
                             engine=engine)
    return probes


@audit_program(
    "ivf_pq.full_search", transient_bytes=4 << 20,
    notes="coarse + top-n_probes + the hoisted-LUT probe scan (B4 scan "
          "mode on the card) — the serving engine's IVF-PQ backend")
def _full_search_impl(queries: torch.Tensor, index: Index, k: int,
                      n_probes: int, lut_dtype_name: str,
                      engines: Tuple[str, str],
                      tombstones: Optional[torch.Tensor] = None,
                      sqrt: bool = True, *, int_dtype: str = "float32",
                      hoisted: bool = True):
    """Coarse ranking + top-n_probes + probe scoring of one batch — the
    serving entry point."""
    probes = coarse_probes(queries, index, n_probes, engines[0])
    return _search_batch_impl(queries, probes, index, k, lut_dtype_name,
                              engines, tombstones, sqrt,
                              int_dtype=int_dtype, hoisted=hoisted)


#: the serving program (coarse + select + probe scan), keyed per
#: signature (``raft_tpu/neighbors/ivf_pq.py:1443`` ``_full_search_aot``);
#: ``search`` and the serving engine's IVF-PQ backend dispatch it
_full_search_aot = aot(_full_search_impl, static_argnums=(2, 3, 4, 5))


def hoisted_batch_cap_dims(metric, per_cluster: bool, n_phys: int,
                           max_chunks: int, n_lists: int, pq_dim: int,
                           pq_bits: int, n_probes: int, lut_dtype: str,
                           hoisted: bool) -> Optional[int]:
    """Query-batch cap (a power of two) bounding the hoisted pipeline's
    per-batch transients to ~128 MiB, from the layout's numbers, or None
    when the config builds no per-(query, probe) tables (the legacy path,
    PER_SUBSPACE at the float32 LUT, PER_SUBSPACE inner product): ~3 f32
    copies with an n_probes axis plus the per-step slices over the
    expanded physical budget in the LUT type.  The JAX package's formula,
    shared by :func:`search`'s query batching, the serving engine's
    super-batch clamp and the tiered searcher."""
    is_ip = DistanceType(int(metric)) == DistanceType.InnerProduct
    if not (hoisted and (per_cluster or (not is_ip
                                         and lut_dtype != "float32"))):
        return None
    budget = min(n_probes * max_chunks, n_probes + max(0, n_phys - n_lists))
    cell = pq_dim * (1 << pq_bits)
    per_q = cell * (3 * n_probes * 4
                    + budget * _LUT_DTYPES[lut_dtype].itemsize)
    return 1 << max(5, ((128 << 20) // max(per_q, 1)).bit_length() - 1)


def hoisted_batch_cap(index: Index, n_probes: int, lut_dtype: str,
                      hoisted: bool = True) -> Optional[int]:
    """:func:`hoisted_batch_cap_dims` of *index*."""
    return hoisted_batch_cap_dims(
        index.metric, index.per_cluster, index.list_codes.shape[0] - 1,
        index.chunk_table.shape[1], index.n_lists, index.pq_dim,
        index.pq_bits, n_probes, lut_dtype, hoisted)


def check_search_params(params: SearchParams) -> None:
    expects(params.lut_dtype in _LUT_DTYPES,
            f"lut_dtype must be one of {list(_LUT_DTYPES)}")
    expects(params.internal_distance_dtype in _INTERNAL_DTYPES,
            f"internal_distance_dtype must be one of "
            f"{list(_INTERNAL_DTYPES)}")


@auto_sync_handle
def search(params: SearchParams, index: Index, queries, k: int, *,
           batch_size_query: int = 1024, handle=None,
           engine: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search (reference ``ivf_pq::search``): returns (distances (nq, k)
    f32, PQ-approximate, indices (nq, k) int32) on the index's device.
    Queries must have the index's dataset dtype or float32.  ``engine``
    picks kernels B2 and B4 (``"cuda"``) or their plain versions
    (``"torch"``); the default follows the device.  The tail batch is
    padded to the power-of-two bucket ladder.

    *handle*: the work runs on its main stream (``auto_sync_handle``);
    with a stream pool, query batch ``bi`` runs on
    ``handle.get_next_usable_stream(bi)`` (reference handle.hpp:117-130),
    which first waits for the work that made the queries, and the final
    concatenation waits for every pool stream.  Each batch gives the bits
    it gives without a handle."""
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
    hoisted = _resolve_hoisted(params)
    cap = hoisted_batch_cap(index, n_probes, params.lut_dtype, hoisted)
    if cap is not None:
        batch_size_query = min(batch_size_query, cap)
    engines = _resolve_engines(index, engine)
    pool = handle is not None and handle.is_stream_pool_initialized()
    out_d, out_i, lanes = [], [], {}
    for bi, q0 in enumerate(range(0, q.shape[0], batch_size_query)):
        lane = handle.get_next_usable_stream(bi) if pool else None
        with lane.context() if pool else contextlib.nullcontext():
            qb = q[q0:q0 + batch_size_query]
            n_valid = qb.shape[0]
            bucket = min(bucket_dim(n_valid), batch_size_query)
            if bucket != n_valid:
                qb = torch.cat([qb, qb.new_zeros((bucket - n_valid,
                                                  qb.shape[1]))])
            d, i = _full_search_aot(qb, index, int(k), int(n_probes),
                                     params.lut_dtype, engines,
                                     int_dtype=params.internal_distance_dtype,
                                     hoisted=hoisted)
            d, i = d[:n_valid], i[:n_valid]
        if pool:
            lane.record(d, i, qb)
            lanes[id(lane)] = lane
        out_d.append(d)
        out_i.append(i)
    if lanes:
        _join_lanes(lanes.values(), out_d + out_i)
    if len(out_d) == 1:
        return out_d[0], out_i[0]
    return torch.cat(out_d), torch.cat(out_i)


def _join_lanes(lanes, made) -> None:
    """The current stream waits for each pool lane, and the tensors *made*
    on the lanes are marked as used by it, so the caching allocator does
    not hand their blocks to a lane again before its reads are done."""
    for lane in lanes:
        lane.join()
    if made and made[0].device.type == "cuda":
        cur = torch.cuda.current_stream(made[0].device)
        for t in made:
            t.record_stream(cur)
