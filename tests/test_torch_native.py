"""The port's loader of the native host runtime and the native mailbox
server it starts:

* the loader builds ``native/*.cpp`` into ``build/raft_tpu_torch_native/``
  and writes nothing else (in particular not the JAX package's
  ``native/libraft_tpu_runtime.so``); a missing source and a failed build
  raise, and ``MailboxServer()`` never falls back to the Python server;
* the native server speaks the wire protocol to the JAX package's
  ``TcpMailbox`` and to the port's, both ways; FIFO per tag, tags and
  sessions that do not cross, a large payload;
* a reader that stops draining its socket stalls no other client (the
  JAX package's ``test_comms.py:582`` case).

Worlds of processes over the native coordinator run in
``test_torch_aggregate.py`` (``MailboxServer()`` is the native one)."""

import pathlib
import time

import numpy as np
import pytest

from raft_tpu_torch import native
from raft_tpu_torch.comms import hostcomm

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def native_server():
    with hostcomm.MailboxServer() as server:
        assert server.backend == "native"
        yield f"{server.address[0]}:{server.address[1]}"


def _sources():
    return {p: p.stat().st_mtime_ns for p in (ROOT / "native").iterdir()
            if p.suffix in (".cpp", ".txt") or p.name == "Makefile"}


def test_loader_writes_only_under_build(monkeypatch, tmp_path):
    assert native.BUILD_DIR == ROOT / "build" / "raft_tpu_torch_native"
    assert native.SOURCE_DIR == ROOT / "native"
    out_dir = tmp_path / "build" / "raft_tpu_torch_native"
    monkeypatch.setattr(native, "BUILD_DIR", out_dir)
    before = _sources()
    lib = native.build()
    assert lib.parent == out_dir and lib.is_file()
    assert sorted(p.name for p in out_dir.iterdir()) == [lib.name]
    # nothing of the port's lands beside the sources, where the JAX
    # package builds its own library (which its tests may be writing now)
    assert _sources() == before
    assert not any("torch" in p.name for p in (ROOT / "native").iterdir())
    assert native.build() == lib            # built once per source hash


def test_missing_source_raises(monkeypatch, tmp_path):
    src = tmp_path / "native"
    src.mkdir()
    (src / "raft_runtime.cpp").write_text("int x;\n")
    monkeypatch.setattr(native, "SOURCE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(FileNotFoundError, match="hostcomm_server.cpp"):
        native.build()
    assert not (tmp_path / "out").exists()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    src = tmp_path / "native"
    src.mkdir()
    for name in native.SOURCES:
        (src / name).write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(native.NativeBuildError, match="error"):
        native.build()
    # no library and no temporary file is left
    assert list((tmp_path / "out").iterdir()) == []


def test_server_build_failure_raises_no_fallback(monkeypatch):
    def broken():
        raise native.NativeBuildError("g++ exited 1")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", broken)
    with pytest.raises(native.NativeBuildError):
        hostcomm.MailboxServer()
    with pytest.raises(Exception, match="unknown backend"):
        hostcomm.MailboxServer(backend="auto")


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_jax_client_against_native_server(native_server, direction):
    from raft_tpu.comms import hostcomm as jhost

    port = hostcomm.TcpMailbox(native_server, "s", 0)
    jax = jhost.TcpMailbox(native_server, "s", 1)
    src, dst = (port, jax) if direction == "port_to_jax" else (jax, port)
    src.put(dst=dst.rank, tag=-4, obj={"ids": np.arange(5, dtype=np.int32)})
    np.testing.assert_array_equal(
        dst.get(src=src.rank, tag=-4, timeout=10)["ids"], np.arange(5))
    with pytest.raises(TimeoutError):
        dst.get(src=src.rank, tag=99, timeout=0.2)
    port.close()
    jax.close()


def test_fifo_tags_sessions_and_large_payload(native_server):
    a = hostcomm.TcpMailbox(native_server, "fifo", 0)
    b = hostcomm.TcpMailbox(native_server, "fifo", 1)
    for i in range(50):
        a.put(dst=1, tag=i % 3, obj=i)
    for tag in (2, 0, 1):
        assert [b.get(0, tag, 5) for _ in range(50 // 3 + (tag < 50 % 3))
                ] == list(range(tag, 50, 3))
    a.put(dst=1, tag=5, obj="only tag 5")
    with pytest.raises(TimeoutError):
        b.get(0, 6, 0.2)
    with pytest.raises(TimeoutError):
        hostcomm.TcpMailbox(native_server, "other", 1).get(0, 5, 0.2)
    assert b.get(0, 5, 5) == "only tag 5"
    big = np.random.default_rng(0).standard_normal(3_000_000).astype(
        np.float32)                                         # 12 MB
    a.put(dst=1, tag=0, obj=big)
    np.testing.assert_array_equal(b.get(0, 0, 30), big)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_stalled_reader_does_not_block_others(native_server, client):
    """A peer that asks for a large payload and then stops draining its
    socket must not stall the coordinator: its reply queues on its own
    connection while other clients' calls go on."""
    from raft_tpu.comms import hostcomm as jhost

    mod = hostcomm if client == "port" else jhost
    slow = mod.TcpMailbox(native_server, "s", 0)
    fast = mod.TcpMailbox(native_server, "s", 1)
    try:
        slow.put(0, 1, b"x" * (8 << 20))     # 8 MB boxed for rank 0
        sock = slow._sock()
        # the request, and no read of the reply: it overflows the kernel
        # buffer and must wait on the server, on slow's connection only
        sock.sendall(hostcomm._encode_req(hostcomm._OP_GET, b"s", 0, 0, 1,
                                          30.0))
        time.sleep(0.2)
        t0 = time.perf_counter()
        for i in range(100):
            fast.put(1, 2, i)
            assert fast.get(1, 2) == i
        assert time.perf_counter() - t0 < 5.0, "the coordinator stalled"
        ok, payload = hostcomm._recv_reply(sock)
        assert ok and len(payload) > (8 << 20)
    finally:
        slow.close()
        fast.close()
