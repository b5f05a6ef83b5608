"""The port's loader of the native host runtime: the C++ sources under
``native/`` of this checkout (``raft_runtime.cpp``,
``hostcomm_server.cpp``), built with ``g++ -O3 -std=c++17 -fPIC -shared
-lpthread`` at first use and loaded with ``ctypes`` (the role of
``raft_tpu/native/__init__.py`` :29-45, :147-175 in the JAX package).

The library goes into ``build/raft_tpu_torch_native/`` under a name that
carries a hash of the sources and flags, so a changed source builds
anew; a build writes a temporary file beside it and renames it into
place, so processes building at once never read a part.  The sources are
read where they are and nothing is written beside them: the JAX package
builds its own library into ``native/``, and the two must not share an
output.

Bound here: the mailbox server (``rt_mailbox_server_start`` /
``_stop``), the single-linkage dendrogram and its cut
(``rt_build_dendrogram``, ``rt_extract_flattened_clusters``), the
monotonic relabelling (``rt_make_monotonic``), the host COO
canonicalisation (``rt_coo_canonicalize``) and the CSR → ELL-hybrid
conversion (``rt_csr_to_ell``), with the C signatures of
``raft_tpu/native/__init__.py`` :48-80.  Unlike the JAX loader, there is
no quiet fallback: a failed build raises :class:`NativeBuildError` with
g++'s error output, a missing source raises ``FileNotFoundError``, and no
entry point drops to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

#: the checkout this package lies in
ROOT = pathlib.Path(__file__).resolve().parents[1]
#: where the sources are read
SOURCE_DIR = ROOT / "native"
SOURCES = ("raft_runtime.cpp", "hostcomm_server.cpp")
#: where the library is written
BUILD_DIR = ROOT / "build" / "raft_tpu_torch_native"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
#: the longest one build may take
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """g++ failed to build the native runtime (its stderr is the
    message)."""


def library_path() -> pathlib.Path:
    """The library the current sources build into (hash of the sources and
    flags).  Raises ``FileNotFoundError`` when a source is missing."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        src = SOURCE_DIR / name
        if not src.is_file():
            raise FileNotFoundError(
                f"native runtime: missing source {src}")
        h.update(name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libraft_tpu_torch_runtime-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Build the library unless it is built already; returns its path."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp),
           *(str(SOURCE_DIR / s) for s in SOURCES), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"native runtime: g++ exited {proc.returncode}:\n"
                f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The loaded runtime, built at first use (once a process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _bind(lib: ctypes.CDLL) -> None:
    """Declare every symbol's signature."""
    lib.rt_mailbox_server_start.restype = ctypes.c_longlong
    lib.rt_mailbox_server_start.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.rt_mailbox_server_stop.restype = ctypes.c_int
    lib.rt_mailbox_server_stop.argtypes = [ctypes.c_longlong]
    lib.rt_build_dendrogram.restype = ctypes.c_int
    lib.rt_build_dendrogram.argtypes = [_I32P, _I32P, ctypes.c_int64,
                                        _I64P, _I64P]
    lib.rt_extract_flattened_clusters.restype = ctypes.c_int
    lib.rt_extract_flattened_clusters.argtypes = [
        _I64P, ctypes.c_int64, ctypes.c_int64, _I32P]
    lib.rt_make_monotonic.restype = ctypes.c_int64
    lib.rt_make_monotonic.argtypes = [_I32P, ctypes.c_int64, ctypes.c_int32,
                                      _I32P]
    lib.rt_coo_canonicalize.restype = ctypes.c_int64
    lib.rt_coo_canonicalize.argtypes = [
        _I32P, _I32P, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_int]
    lib.rt_csr_to_ell.restype = ctypes.c_int
    lib.rt_csr_to_ell.argtypes = [
        _I64P, _I32P, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _I32P, ctypes.c_char_p, _I32P, _I32P,
        ctypes.c_char_p]


def _contig(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=dtype)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _bytes(a: np.ndarray):
    return ctypes.cast(a.ctypes.data, ctypes.c_char_p)


def build_dendrogram(src, dst, weights
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Union-find agglomerative labelling of weight-sorted MST edges
    (reference cluster/detail/agglomerative.cuh:103
    ``build_dendrogram_host``): scipy-linkage-style (children (n−1, 2)
    int64, deltas (a copy of *weights*), sizes (n−1,) int64).  Raises
    ``ValueError`` when the edges do not form a forest."""
    src = _contig(src, np.int32)
    dst = _contig(dst, np.int32)
    weights = np.asarray(weights)
    n_edges = src.shape[0]
    if dst.shape != src.shape or weights.shape != src.shape:
        raise ValueError("build_dendrogram: src, dst and weights must have "
                         "one length")
    children = np.empty((n_edges, 2), np.int64)
    sizes = np.empty((n_edges,), np.int64)
    if n_edges and (src.min() < 0 or dst.min() < 0
                    or max(src.max(), dst.max()) > n_edges):
        raise ValueError("build_dendrogram: a vertex id lies outside "
                         "[0, n_edges]")
    rc = load().rt_build_dendrogram(_ptr(src, ctypes.c_int32),
                                    _ptr(dst, ctypes.c_int32), n_edges,
                                    _ptr(children, ctypes.c_int64),
                                    _ptr(sizes, ctypes.c_int64))
    if rc != 0:
        raise ValueError("build_dendrogram: edges do not form a forest")
    return children, np.array(weights, copy=True), sizes


def extract_flattened_clusters(children, n_clusters: int,
                               n: int) -> np.ndarray:
    """Cut the dendrogram at *n_clusters* (reference
    detail/agglomerative.cuh:239): apply the first n − n_clusters merges
    and label the forest 0..n_clusters−1 by root order; int32 labels."""
    children = _contig(children, np.int64)
    if children.shape != (n - 1, 2):
        raise ValueError(f"extract_flattened_clusters: children must be "
                         f"({n - 1}, 2), got {children.shape}")
    labels = np.empty((n,), np.int32)
    rc = load().rt_extract_flattened_clusters(
        _ptr(children, ctypes.c_int64), int(n), int(n_clusters),
        _ptr(labels, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"extract_flattened_clusters: n_clusters "
                         f"{n_clusters} outside [1, {n}]")
    return labels


def make_monotonic(labels, zero_based: bool = True
                   ) -> Tuple[np.ndarray, int]:
    """Dense relabelling in sorted order of the distinct labels (reference
    label/classlabels.cuh make_monotonic): (out int32, n_unique)."""
    labels = _contig(labels, np.int32)
    out = np.empty_like(labels)
    k = load().rt_make_monotonic(_ptr(labels, ctypes.c_int32),
                                 labels.shape[0], 0 if zero_based else 1,
                                 _ptr(out, ctypes.c_int32))
    return out, int(k)


def coo_canonicalize(rows, cols, vals, drop_zeros: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort COO triplets by (row, col), sum duplicates (in float64, in
    sorted order) and drop explicit zeros: the compacted (rows int32, cols
    int32, vals float64)."""
    rows = _contig(rows, np.int32).copy()
    cols = _contig(cols, np.int32).copy()
    # exempt(dtype-drift): rt_coo_canonicalize takes double values
    vals = _contig(vals, np.float64).copy()
    if not rows.shape == cols.shape == vals.shape:
        raise ValueError("coo_canonicalize: rows, cols and vals must have "
                         "one length")
    nnz = load().rt_coo_canonicalize(
        _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
        _ptr(vals, ctypes.c_double), rows.shape[0], 1 if drop_zeros else 0)
    return rows[:nnz], cols[:nnz], vals[:nnz]


def csr_to_ell(indptr, indices, data, r: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                          np.ndarray]:
    """CSR → ELL hybrid on the host: (cols (n, r) int32, vals (n, r),
    overflow rows, cols and vals) — each row's first *r* entries in the
    padded block (zeros past the row's end), the rest in the overflow
    arrays in row order."""
    indptr = _contig(indptr, np.int64)
    indices = _contig(indices, np.int32)
    data = np.ascontiguousarray(np.asarray(data))
    n_rows = indptr.shape[0] - 1
    nnz_row = np.diff(indptr)
    if (nnz_row < 0).any() or (n_rows and indptr[-1] > indices.shape[0]):
        raise ValueError("csr_to_ell: malformed indptr")
    n_ov = int(np.maximum(nnz_row - r, 0).sum())
    ell_cols = np.zeros((n_rows, r), np.int32)
    ell_vals = np.zeros((n_rows, r), data.dtype)
    ov_rows = np.empty(n_ov, np.int32)
    ov_cols = np.empty(n_ov, np.int32)
    ov_vals = np.empty(n_ov, data.dtype)
    rc = load().rt_csr_to_ell(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _bytes(data), data.dtype.itemsize, n_rows, int(r),
        _ptr(ell_cols, ctypes.c_int32), _bytes(ell_vals),
        _ptr(ov_rows, ctypes.c_int32), _ptr(ov_cols, ctypes.c_int32),
        _bytes(ov_vals))
    if rc != 0:
        raise ValueError("csr_to_ell: malformed indptr")
    return ell_cols, ell_vals, ov_rows, ov_cols, ov_vals


def mailbox_server_start(host: str = "127.0.0.1",
                         port: int = 0) -> Tuple[int, int]:
    """Start the native poll-loop mailbox server on *host*:*port* (0: an
    ephemeral port); returns (handle, bound port).  Raises ``OSError``
    when the address cannot be bound."""
    port_out = ctypes.c_int(0)
    handle = load().rt_mailbox_server_start(host.encode(), int(port),
                                            ctypes.byref(port_out))
    if handle < 0:
        raise OSError(f"native mailbox server: cannot listen on "
                      f"{host}:{port}")
    return int(handle), int(port_out.value)


def mailbox_server_stop(handle: int) -> None:
    """Stop a server :func:`mailbox_server_start` started (joins its poll
    thread)."""
    if load().rt_mailbox_server_stop(int(handle)) != 0:
        raise ValueError(f"native mailbox server: no server {handle}")
