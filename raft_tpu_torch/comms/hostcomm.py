"""Cross-process host p2p plane (port of ``raft_tpu/comms/hostcomm.py``)
— the role UCX plays in the reference (comms/detail/ucp_helper.hpp,
std_comms.hpp:55-96: tagged host send/recv beside the NCCL device plane).

Device traffic rides ``torch.distributed`` collectives; what is left for
the host plane is small tagged control messages (worker metadata,
rendezvous, the fleet telemetry exchange).  A TCP mailbox keyed by
``(session, src, dst, tag)`` covers that without bringing in a transport
framework: one process (conventionally host rank 0) runs
:class:`MailboxServer`; every process — including rank 0 — talks to it
with :class:`TcpMailbox`.

The server is the native poll loop of ``native/hostcomm_server.cpp``
(``backend == "native"``, built by the port's own loader,
:mod:`raft_tpu_torch.native`), or the threaded stdlib one when
``backend="python"`` is asked for.

Wire protocol (the JAX package's, byte for byte, so each package's client
talks to the other's server; all integers big-endian)::

    request:  u32 len | u8 op (1=put, 2=get) | u16 session_len | session
              | i64 src | i64 dst | i64 tag | f64 timeout_s | payload
    reply:    u32 len | u8 status (1=ok, 0=timeout/error) | payload

The SERVER never deserializes payloads (it routes bytes); clients pickle/
unpickle them.  Trust model matches the reference's UCX plane: a private
cluster interconnect — do not expose the port beyond it.
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import socketserver
import struct
import threading
from typing import Any, Dict, Optional, Tuple

from raft_tpu_torch.core.error import LogicError

_LEN = struct.Struct(">I")
_OP_PUT, _OP_GET = 1, 2
_REQ_HEAD = struct.Struct(">BH")      # op, session_len
_KEY_TAIL = struct.Struct(">qqq")     # src, dst, tag
_TIMEOUT = struct.Struct(">d")


def _encode_req(op: int, session_b: bytes, src: int, dst: int, tag: int,
                timeout: float, payload: bytes = b"") -> bytes:
    body = (_REQ_HEAD.pack(op, len(session_b)) + session_b
            + _KEY_TAIL.pack(src, dst, tag) + _TIMEOUT.pack(timeout)
            + payload)
    return _LEN.pack(len(body)) + body


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("mailbox peer closed")
        buf += chunk
    return buf


def _recv_reply(sock: socket.socket) -> Tuple[bool, bytes]:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    body = _recv_exact(sock, n)
    return body[0] == 1, body[1:]


class _PyMailboxServer:
    """The threaded stdlib server speaking the binary protocol."""

    def __init__(self, host: str, port: int):
        # key → [Queue, waiter_count].  Puts happen under the lock (Queue.put
        # never blocks) so a drained box can be reaped exactly when it is
        # empty AND unwaited — long-lived coordinators must not accumulate
        # one dead dict entry per (session, src, dst, tag) ever used.
        boxes: Dict[bytes, list] = {}
        lock = threading.Lock()

        def put(key, payload):
            with lock:
                entry = boxes.setdefault(key, [queue.Queue(), 0])
                entry[0].put(payload)

        def get(key, timeout):
            with lock:
                entry = boxes.setdefault(key, [queue.Queue(), 0])
                entry[1] += 1
            try:
                return entry[0].get(timeout=timeout)
            finally:
                with lock:
                    entry[1] -= 1
                    if entry[1] == 0 and entry[0].empty():
                        boxes.pop(key, None)

        def reply(sock, ok: bool, payload: bytes = b"") -> None:
            body = (b"\x01" if ok else b"\x00") + payload
            sock.sendall(_LEN.pack(len(body)) + body)

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        (n,) = _LEN.unpack(
                            _recv_exact(self.request, _LEN.size))
                        f = _recv_exact(self.request, n)
                        op, slen = _REQ_HEAD.unpack_from(f, 0)
                        key_end = _REQ_HEAD.size + slen + _KEY_TAIL.size
                        key = f[_REQ_HEAD.size:key_end]
                        (timeout,) = _TIMEOUT.unpack_from(f, key_end)
                        payload = f[key_end + _TIMEOUT.size:]
                        if op == _OP_PUT:
                            put(key, payload)
                            reply(self.request, True)
                        elif op == _OP_GET:
                            try:
                                got = get(key, timeout)
                                reply(self.request, True, got)
                            except queue.Empty:
                                reply(self.request, False, b"timeout")
                        else:
                            reply(self.request, False, b"bad op")
                except (ConnectionError, EOFError, OSError, struct.error):
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address: Tuple[str, int] = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="raft-tpu-torch-mailbox")
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class MailboxServer:
    """TCP mailbox coordinator: PUT appends to a keyed queue, GET blocks
    until a message for the key arrives (or times out).

    ``address`` reports the bound (host, port) so callers can pass it to
    workers (port 0 → ephemeral).  ``backend`` is "native" (the default:
    the C++ poll loop, one thread, no interpreter lock) or "python" (the
    threaded stdlib server), as asked.  Unlike the JAX package, which
    falls back to the Python server without a word when the native
    runtime is not there, the native backend raises when its build fails
    (:class:`raft_tpu_torch.native.NativeBuildError`): a coordinator is
    never quietly the slower one.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 backend: str = "native"):
        if backend not in ("native", "python"):
            raise LogicError(f"MailboxServer: unknown backend {backend!r}")
        self.backend = backend
        self._native_handle: Optional[int] = None
        self._py: Optional[_PyMailboxServer] = None
        if backend == "native":
            from raft_tpu_torch import native

            self._native_handle, bound = native.mailbox_server_start(host,
                                                                     port)
            self.address: Tuple[str, int] = (host, bound)
        else:
            self._py = _PyMailboxServer(host, port)
            self.address = self._py.address

    def close(self) -> None:
        if self._native_handle is not None:
            from raft_tpu_torch import native

            native.mailbox_server_stop(self._native_handle)
            self._native_handle = None
        if self._py is not None:
            self._py.close()
            self._py = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class TcpMailbox:
    """Client of a :class:`MailboxServer` — the per-process host p2p
    endpoint (ucp_helper.hpp's send/recv handles).

    One persistent connection per thread (the server handles each
    connection independently, so a blocking GET does not stall PUTs from
    other processes).  Payloads are pickled client-side; the server routes
    opaque bytes.
    """

    def __init__(self, coordinator: str, session_id: str, rank: int,
                 connect_timeout: float = 30.0):
        host, _, port = coordinator.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self.session_id = session_id
        self._session_b = session_id.encode()
        self.rank = rank
        self._local = threading.local()
        self._connect_timeout = connect_timeout

    def _sock(self) -> socket.socket:
        s = getattr(self._local, "sock", None)
        if s is None:
            s = socket.create_connection(self._addr,
                                         timeout=self._connect_timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = s
        return s

    def _rpc(self, req: bytes, timeout: float) -> Tuple[bool, bytes]:
        # The deadline is enforced client-side too (a dead coordinator or a
        # partition without FIN must not hang the clique past the timeout
        # contract); +5s margin lets the server's own queue timeout answer
        # first in the healthy case.
        s = self._sock()
        s.settimeout(timeout + 5.0)
        try:
            s.sendall(req)
            return _recv_reply(s)
        except socket.timeout:
            # connection state is now ambiguous (a late reply would
            # desynchronize the framing) — drop it
            self.close()
            raise TimeoutError(
                f"mailbox coordinator {self._addr} unresponsive after "
                f"{timeout + 5.0:.0f}s") from None
        except (ConnectionError, OSError):
            # dead socket must not be cached: the next RPC reconnects
            # (e.g. a restarted coordinator on the same address)
            self.close()
            raise

    def put(self, dst: int, tag: int, obj: Any, timeout: float = 60.0) -> None:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        req = _encode_req(_OP_PUT, self._session_b, self.rank, dst, tag,
                          timeout, payload)
        ok, err = self._rpc(req, timeout)
        if not ok:
            raise LogicError(f"mailbox put failed: {err.decode(errors='replace')}")

    def get(self, src: int, tag: int, timeout: float = 60.0) -> Any:
        req = _encode_req(_OP_GET, self._session_b, src, self.rank, tag,
                          timeout)
        ok, payload = self._rpc(req, timeout)
        if not ok:
            raise TimeoutError(
                f"mailbox get timed out: src={src} tag={tag} "
                f"session={self.session_id}")
        return pickle.loads(payload)

    def close(self) -> None:
        s = getattr(self._local, "sock", None)
        if s is not None:
            s.close()
            self._local.sock = None


_BARRIER_TAG = -0xB0B  # reserved tag for host_barrier rounds


def host_barrier(mailbox: TcpMailbox, rank: int, world: int,
                 timeout: float = 60.0) -> None:
    """Cross-process rendezvous over the mailbox (the reference's barrier
    rides the NCCL clique, comms_t::barrier core/comms.hpp:255; multi-host
    control rendezvous is the UCX plane's job).

    Flat gather-release on one reserved tag: every rank PUTs a token to
    rank 0; rank 0 collects ``world-1`` tokens then releases everyone.
    Back-to-back barriers are safe without epoch numbering — each
    (src → dst, tag) mailbox is FIFO, so tokens from barrier N+1 queue
    behind barrier N's.
    """
    tag = _BARRIER_TAG
    if world <= 1:
        return
    if rank == 0:
        for src in range(1, world):
            got = mailbox.get(src, tag, timeout)
            if got != ("arrive", src):
                raise LogicError(f"barrier: bad token {got!r} from {src}")
        for dst in range(1, world):
            mailbox.put(dst, tag, ("release", 0))
    else:
        mailbox.put(0, tag, ("arrive", rank))
        got = mailbox.get(0, tag, timeout)
        if got != ("release", 0):
            raise LogicError(f"barrier: bad release {got!r}")


def default_coordinator() -> Optional[str]:
    """RAFT_TPU_COORD_ADDR, if set (the raft-dask session passes the
    scheduler address around the same way)."""
    return os.environ.get("RAFT_TPU_COORD_ADDR") or None
