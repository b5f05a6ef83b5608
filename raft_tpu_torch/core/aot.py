"""Per-signature warm cache and the persistent kernel cache (port of
``raft_tpu/core/aot.py``: ``aot`` :598, ``AotFunction`` :314,
``aot_compile_counters`` :51, ``enable_persistent_cache`` /
``try_enable_persistent_cache`` :172, :188).

The reference's counterpart in RAFT is ``libraft-distance`` /
``libraft-nn`` (SURVEY.md §2.14): precompiled template instantiations, so
a fresh process's first call links instead of compiling.  In the JAX
package :func:`aot` lowers and compiles an XLA executable once per
(shape bucket, dtype) signature.  Eager PyTorch compiles no program: the
port's compiled artifacts are the ``nvcc``-built kernel libraries and the
``g++``-built host runtime, and what a first call of a signature costs is
loading those libraries, cuBLAS sizing its workspace for the shape and the
caching allocator growing to the shape's blocks.  So here:

- :class:`AotFunction` keys each call on its signature — the function's
  qualname, each tensor leaf's shape, dtype and device, and the static
  values — and the first call of a signature counts as its
  compile: ``aot_compile_counters["compiles"]`` and
  ``["compiles:{qualname}"]`` go up by one.  A serving engine snapshots
  the counter after ``ServeEngine.warmup()`` and requires it unchanged
  under traffic over the warmed buckets (the zero-compile contract).
- :meth:`AotFunction.compiled` warms a signature from specs without data:
  it runs the function once on zeros of that signature.
- :func:`enable_persistent_cache` points both build directories (the CUDA
  kernels' and the native runtime's) at ``<base>/<fingerprint>``, so the
  libraries survive the process and are shared by every process on the
  machine; ``core/prewarm.py`` fills it ahead of time.  Without a call
  the libraries build into the checkout's ``build/``.

A call made while another :class:`AotFunction` runs (``select_k`` inside
an IVF search) runs inline and counts nothing: it is part of the outer
program's signature, as a traced call is in the JAX package.

Not ported, each for its reason:

- ``MeshAotFunction`` / ``mesh_aot`` (:500, :591): the port runs one
  process per rank and builds no mesh programs (:func:`mesh_aot` raises);
  each rank keys its own shard programs with :func:`aot`
  (``neighbors/ann_mnmg.py``: the scan and the fold, with the one
  allgather between them).
- ``is_tracer``, ``aot_dispatchable``, ``dispatch_device``: eager PyTorch
  has no tracers, and a tensor carries its own device, which the
  signature keys on.
- ``_ensure_persistent_cache``'s implicit enabling: the cache directory is
  used only when a caller asks for it (:func:`enable_persistent_cache`).
- ``bucket=True`` (the reference's :314, which pads each leaf's leading
  dimension to ``_bucket_dim``): the port's callers pad their query
  batches to :func:`~raft_tpu_torch.core.buckets.bucket_dim` themselves —
  clamped to their batch size, the query argument alone, the serving
  engine to its warmed buckets — as the reference's callers do (none of
  them passes ``bucket=True``), so the signature keys on the shapes they
  pass and there is one bucketing mechanism.
- ``donate_argnums``: an eager function writes in place by itself
  (``index_copy_``); nothing is donated.
- The executable store (``core/aotstore.py``): see that stub.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import pathlib
import platform
import subprocess
import threading
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from raft_tpu_torch import telemetry

#: First calls by key: ``"compiles"`` and ``"compiles:{qualname}"`` go up
#: once per new signature of an :class:`AotFunction`.  Registry-backed
#: (``raft_tpu_aot_compiles{key}``), atomic increments, live under
#: ``RAFT_TPU_TELEMETRY=0`` (counters always are).  Never reset in library
#: code — tests snapshot and diff.
aot_compile_counters: telemetry.LegacyCounterView = telemetry.legacy_counter(
    "raft_tpu_aot_compiles", "first calls of an AOT signature by key")


class TensorSpec(NamedTuple):
    """A tensor's signature without its data, for :meth:`AotFunction.
    compiled` (a plain ``(shape, dtype, device)`` tuple is read the same
    way)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: Any = "cpu"


def _norm_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _as_spec(leaf) -> Optional[TensorSpec]:
    """*leaf* as a :class:`TensorSpec` when it is one, or a plain
    ``(shape, dtype, device)`` tuple; None otherwise."""
    if isinstance(leaf, TensorSpec):
        return leaf
    if (type(leaf) is tuple and len(leaf) == 3
            and isinstance(leaf[1], torch.dtype)
            and isinstance(leaf[0], (tuple, list, torch.Size))):
        return TensorSpec(tuple(leaf[0]), leaf[1], leaf[2])
    return None


#: nesting depth of AotFunction runs on this thread, and its first calls
_DEPTH = threading.local()


def thread_compiles() -> int:
    """First calls made on the calling thread so far (what a reader
    thread counts while a writer thread rewarms: the global
    ``aot_compile_counters`` sees both)."""
    return getattr(_DEPTH, "compiles", 0)


class AotFunction:
    """A function with a per-signature warm cache (see the module doc).

    ``static_argnums`` name the positional arguments keyed by value (they
    must be hashable); every other argument, and every keyword argument,
    is keyed by its structure: a tensor by its shape, dtype and device;
    a tuple, list, dict or dataclass by its members; anything else by its
    value when hashable, else by its type and identity.  Callers pad
    ragged batches to :func:`~raft_tpu_torch.core.buckets.bucket_dim`, so
    they share a handful of signatures."""

    def __init__(self, fn: Callable, static_argnums: Tuple[int, ...] = ()):
        self._fn = fn
        self._static = frozenset(static_argnums)
        self._cache: set = set()
        self._lock = threading.Lock()
        self._name = getattr(fn, "__qualname__", repr(fn))
        functools.update_wrapper(self, fn)

    # -- signatures ---------------------------------------------------------

    def _key(self, a):
        if isinstance(a, torch.Tensor):
            return ("T", tuple(a.shape), a.dtype, a.device)
        spec = _as_spec(a)
        if spec is not None:
            return ("T", tuple(spec.shape), spec.dtype,
                    _norm_device(spec.device))
        if isinstance(a, (tuple, list)):
            return (type(a).__name__,) + tuple(self._key(e) for e in a)
        if isinstance(a, dict):
            return ("dict",) + tuple((k, self._key(a[k]))
                                     for k in sorted(a, key=repr))
        if dataclasses.is_dataclass(a) and not isinstance(a, type):
            return (type(a).__qualname__,) + tuple(
                (f.name, self._key(getattr(a, f.name, None)))
                for f in dataclasses.fields(a))
        try:
            hash(a)
        except TypeError:
            return ("id", type(a).__qualname__, id(a))
        return a

    def _signature(self, args, kwargs) -> tuple:
        sig = [self._name]
        for i, a in enumerate(args):
            sig.append(("static", a) if i in self._static else self._key(a))
        for k in sorted(kwargs):
            sig.append((k, self._key(kwargs[k])))
        return tuple(sig)

    def _first_call(self, sig) -> None:
        """Record *sig*; a new one counts as a compile."""
        with self._lock:
            if sig in self._cache:
                return
            self._cache.add(sig)
        aot_compile_counters.inc("compiles")
        aot_compile_counters.inc(f"compiles:{self._name}")
        _DEPTH.compiles = thread_compiles() + 1

    # -- calls --------------------------------------------------------------

    def _run(self, args, kwargs):
        _DEPTH.n = getattr(_DEPTH, "n", 0) + 1
        try:
            return self._fn(*args, **kwargs)
        finally:
            _DEPTH.n -= 1

    def __call__(self, *args, **kwargs):
        if getattr(_DEPTH, "n", 0):
            # inside another AotFunction's run: part of its signature
            return self._fn(*args, **kwargs)
        self._first_call(self._signature(args, kwargs))
        return self._run(args, kwargs)

    def compiled(self, *args, **kwargs):
        """Warm the signature of *args* (tensors, or ``(shape, dtype,
        device)`` specs for the dynamic arguments): run the function once
        on zeros of that signature, mark it warm and return the result.
        What this pays for in eager PyTorch is the first call's cost —
        loading the kernel libraries, cuBLAS sizing its workspace, the
        caching allocator growing — so a later call of the signature pays
        none of it."""
        def zeros(a):
            spec = _as_spec(a)
            if spec is not None:
                return torch.zeros(tuple(spec.shape), dtype=spec.dtype,
                                   device=_norm_device(spec.device))
            if isinstance(a, (tuple, list)):
                return type(a)(zeros(e) for e in a)
            return a

        args = tuple(a if i in self._static else zeros(a)
                     for i, a in enumerate(args))
        kwargs = {k: zeros(v) for k, v in kwargs.items()}
        self._first_call(self._signature(args, kwargs))
        return self._run(args, kwargs)

    def is_warm(self, *args, **kwargs) -> bool:
        """True when the signature of *args* (tensors, or specs for the
        dynamic arguments, as :meth:`compiled` takes them) has had its
        first call; runs nothing."""
        return self._signature(args, kwargs) in self._cache

    @property
    def cache_size(self) -> int:
        return len(self._cache)


def aot(fn: Optional[Callable] = None, *,
        static_argnums: Tuple[int, ...] = ()):
    """Decorator: key *fn*'s calls per (shape, dtype, device, statics)
    signature — see :class:`AotFunction`."""
    if fn is None:
        return lambda f: AotFunction(f, static_argnums)
    return AotFunction(fn, static_argnums)


def mesh_aot(fn: Callable, *, static_argnums: Tuple[int, ...] = ()):
    """Not ported: the JAX package compiles ``shard_map`` programs over a
    mesh; the port runs one process per rank (``comms/``) and each rank
    calls the single-device functions, so there is no mesh program to
    key."""
    raise NotImplementedError(
        "raft_tpu_torch: mesh_aot has no counterpart — one process per "
        "rank, no mesh programs (core/aot.py)")


# ---------------------------------------------------------------------------
# the persistent kernel cache

def _nvcc_release() -> str:
    """``nvcc --version``'s release line, or ``"nvcc:none"``."""
    from raft_tpu_torch.kernels import native as kernels_native

    try:
        out = subprocess.run([kernels_native._nvcc(), "--version"],
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "nvcc:none"
    for line in out.splitlines():
        if "release" in line:
            return line.strip()
    return "nvcc:unknown"


def _machine_fingerprint() -> str:
    """What a built library is only good for: the compiler's release, the
    host's architecture and, with a card present, its compute
    capability."""
    cc = "none"
    if torch.cuda.is_available():
        cc = "sm_%d%d" % torch.cuda.get_device_capability(0)
    blob = f"{_nvcc_release()}|{platform.machine()}|{cc}"
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def cache_base(path: Optional[str] = None) -> pathlib.Path:
    """The cache's base directory: *path*, else ``RAFT_TPU_CACHE_DIR``,
    else ``~/.cache/raft_tpu`` (the reference's precedence)."""
    base = path or os.environ.get(
        "RAFT_TPU_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "raft_tpu"))
    return pathlib.Path(base)


def enable_persistent_cache(path: Optional[str] = None) -> str:
    """Point the CUDA kernels' and the native runtime's build directories
    at ``<base>/<fingerprint>`` (:func:`cache_base`), creating it, and
    return it.  Libraries already loaded stay loaded; every later build
    and load reads and writes there, named by the hash of its sources."""
    from raft_tpu_torch import native as runtime_native
    from raft_tpu_torch.kernels import native as kernels_native

    target = cache_base(path) / _machine_fingerprint()
    target.mkdir(parents=True, exist_ok=True)
    kernels_native.BUILD_DIR = target
    runtime_native.BUILD_DIR = target
    return str(target)


def try_enable_persistent_cache(path: Optional[str] = None
                                ) -> Optional[str]:
    """:func:`enable_persistent_cache`, or None when the directory cannot
    be made (a read-only home)."""
    try:
        return enable_persistent_cache(path)
    except OSError:
        return None


def cache_dir() -> str:
    """The directory kernel libraries build into and load from now."""
    from raft_tpu_torch.kernels import native as kernels_native

    return str(kernels_native.BUILD_DIR)
