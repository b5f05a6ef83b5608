"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``: no PyTorch headers, so a build takes seconds.  The first call
to :func:`library` starts one ``nvcc`` per source, all at once, and waits
for them; later calls return the loaded library.  Libraries are written
under ``build/raft_tpu_torch_kernels/`` at the checkout's root (listed in
``.gitignore``), named by a hash of their source, so an edited source is
never served by a stale library.  A build that fails raises with the
compiler's output.

Every kernel wrapper counts its launches in :data:`LAUNCHES`, so a run can
show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "raft_tpu_torch_kernels")
SOURCES = ("fused_l2nn", "select_k", "ivf_pq_lut", "pairwise")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

#: launches per kernel wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"fused_l2_nn": 0, "fused_l2_nn_partials": 0,
                            "select_k": 0, "lut_score": 0,
                            "pairwise_accumulate": 0}

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
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all() -> None:
    """Compile every source whose library is missing, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
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
            build_all()
            lib = ctypes.CDLL(str(_target(name)))
            _declare(name, lib)
            _libs[name] = lib
        return _libs[name]


def load_all() -> None:
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
        # x, xn, y, yn, val, idx, m, k, d, bf16_dot, stream
        "raft_fused_l2nn": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
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
        # pq_bits, lut_dtype, device, stream
        "raft_lut_score": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P],
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
    """Raise when a launch returned a CUDA error code (the launch check
    each C entry point runs right after its kernel launch)."""
    if err != 0:
        msg = lib.raft_cuda_error_string(err).decode()
        raise RuntimeError(f"raft_tpu_torch: {what} launch failed: CUDA "
                           f"error {err} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
