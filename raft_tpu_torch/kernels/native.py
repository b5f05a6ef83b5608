"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``: no PyTorch headers, so a build takes seconds.
:func:`library` builds its own source alone (the first call), so the
compile probe (``probe.cu``) and one kernel fail or pass without waiting
for the others; :func:`load_all` starts one ``nvcc`` for every missing
source, all at once, and waits for them.  Libraries are written
under ``build/raft_tpu_torch_kernels/`` at the checkout's root (listed in
``.gitignore``), named by a hash of their source and of every header
under ``csrc/``, so an edited source or header is never served by a stale
library.  A build that fails raises with the compiler's whole output.

Every kernel wrapper counts its launches in :data:`LAUNCHES`, so a run can
show which kernels its path went through; :data:`BUILDS` counts the
``nvcc`` runs and library loads, so a run can show that a stage (the
autotuner's exploration, a promotion) built and loaded nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

from raft_tpu_torch.core.error import DeviceError

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "raft_tpu_torch_kernels")
SOURCES = ("probe", "fused_l2nn", "select_k", "ivf_pq_lut", "pairwise")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

#: launches per kernel wrapper since the last :func:`reset_launches`
#: (B4's scan mode counts its launches with a tombstone bitmap apart)
LAUNCHES: Dict[str, int] = {"fused_l2_nn": 0, "fused_l2_nn_partials": 0,
                            "select_k": 0, "lut_score": 0, "lut_scan": 0,
                            "lut_scan_tombstones": 0,
                            "pairwise_accumulate": 0, "add_one": 0}

#: ``nvcc`` runs ("compiled") and libraries loaded into the process
#: ("loaded") since it started
BUILDS: Dict[str, int] = {"compiled": 0, "loaded": 0}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("raft_tpu_torch: nvcc not found (CUDA_HOME, "
                           "/usr/local/cuda, PATH); the CUDA kernels "
                           "cannot be built")
    return found


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> None:
    """Compile each of *names* (default: every source) whose library is
    missing, one ``nvcc`` each, all at once; raises after all have ended
    with the output of each that failed."""
    names = SOURCES if names is None else tuple(names)
    for name in names:
        if name not in SOURCES:
            raise ValueError(f"raft_tpu_torch: no kernel source {name!r}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
        BUILDS["compiled"] += 1
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("raft_tpu_torch: nvcc failed\n" + "\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        if name not in _libs:
            build_all((name,))
            lib = ctypes.CDLL(str(_target(name)))
            _declare(name, lib)
            _libs[name] = lib
            BUILDS["loaded"] += 1
        return _libs[name]


def load_all() -> None:
    """Build every missing library in parallel, then load them all."""
    with _lock:
        build_all()
    for name in SOURCES:
        library(name)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


#: argument types of every exported function (pointers and the stream as
#: c_void_p, so ctypes never cuts them to 32 bits); the result is the CUDA
#: error code (int) unless given beside them
_SIGNATURES = {
    "fused_l2nn": {
        # x, xn, y, yn, val, idx, m, k, d, bf16_dot, tensor_cores, yt,
        # stream
        "raft_fused_l2nn": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                            _P],
        # k, d -> floats of the tensor-core kernel's tiled y
        "raft_fused_l2nn_scratch": ([_I, _I], _L),
        # x, w (nullable), w_stride, y, S, n, k, ds, val, idx, part, sums,
        # wsum, inertia, stream
        "raft_em_small": [_P, _P, _L, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                          _P, _P],
        # S, n, k, ds -> floats of the partials scratch
        "raft_em_small_scratch": ([_I, _I, _I, _I], _L),
        # x, w (nullable), labels, m, k, d, part, sums, wsum, stream
        "raft_cluster_partials": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
        # m, k, d -> floats of the partials scratch
        "raft_cluster_partials_scratch": ([_I, _I, _I], _L),
    },
    "select_k": {
        # x, rows, n, k, select_min, dtype, values, positions, stream
        "raft_select_k": [_P, _I, _I, _I, _I, _I, _P, _P, _P],
    },
    "ivf_pq_lut": {
        # codes, rows, lut, out, nq, n_rows, cap, code_bytes, pq_dim,
        # pq_bits, lut_dtype, acc_mode, device, stream
        "raft_lut_score": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P],
        # codes, phys, sizes, lut, probe_ord, n_luts, base, csum, scale,
        # out_v, out_s, nq, S, n_rows, cap, code_bytes, pq_dim, pq_bits,
        # lut_dtype, kk, select_min, tiles, scratch, counts, ids, tomb_words,
        # n_words, acc_mode, device, stream
        "raft_lut_scan": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                          _P, _I, _I, _I, _P],
        # nq, S, cap, device -> blocks per step, or a negated error code
        "raft_lut_scan_tiles": [_I, _I, _I, _I],
    },
    "probe": {
        # x, out, n, stream
        "raft_add_one": [_P, _P, _L, _P],
    },
    "pairwise": {
        # x, y, out, m, n, k, op, p, dtype, stream
        "raft_pairwise_accumulate": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    },
}


def _declare(name: str, lib: ctypes.CDLL) -> None:
    for fn, sig in _SIGNATURES[name].items():
        argtypes, restype = sig if isinstance(sig, tuple) else (sig, _I)
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.raft_cuda_error_string.argtypes = [_I]
    lib.raft_cuda_error_string.restype = ctypes.c_char_p


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise :class:`DeviceError` when a launch returned a CUDA error code
    (the launch check each C entry point runs right after its kernel
    launch)."""
    if err != 0:
        msg = lib.raft_cuda_error_string(err).decode()
        raise DeviceError(f"raft_tpu_torch: {what} launch failed: CUDA "
                          f"error {err} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
