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

Only the mailbox server is bound here (``rt_mailbox_server_start`` /
``_stop``); the dendrogram, monotonic-label, COO and ELL entry points
come with their callers.  Unlike the JAX loader, there is no quiet
fallback: a failed build raises :class:`NativeBuildError` with g++'s
error output, and a missing source raises ``FileNotFoundError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

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
            lib.rt_mailbox_server_start.restype = ctypes.c_longlong
            lib.rt_mailbox_server_start.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.rt_mailbox_server_stop.restype = ctypes.c_int
            lib.rt_mailbox_server_stop.argtypes = [ctypes.c_longlong]
            _lib = lib
        return _lib


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
