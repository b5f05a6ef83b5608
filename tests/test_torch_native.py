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


# --- the sparse and single-linkage entry points -----------------------------

def _forest(rng, n):
    """Weight-sorted edges of a random spanning tree on n vertices."""
    perm = rng.permutation(n)
    src = perm[1:]
    dst = perm[rng.integers(0, np.arange(1, n))]
    w = np.sort(rng.random(n - 1).astype(np.float32))
    return src.astype(np.int32), dst.astype(np.int32), w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dendrogram_and_cut_against_numpy_twins(seed):
    from raft_tpu_torch.cluster.single_linkage import (
        build_dendrogram_numpy, extract_flattened_clusters_numpy)

    rng = np.random.default_rng(seed)
    n = 257
    src, dst, w = _forest(rng, n)
    got = native.build_dendrogram(src, dst, w)
    want = build_dendrogram_numpy(src, dst, w)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for k in (1, 3, 64, n):
        np.testing.assert_array_equal(
            native.extract_flattened_clusters(got[0], k, n),
            extract_flattened_clusters_numpy(got[0], k, n))
    with pytest.raises(ValueError):
        native.extract_flattened_clusters(got[0], n + 1, n)
    with pytest.raises(ValueError, match="outside"):
        native.build_dendrogram(src, np.full_like(dst, n), w)


@pytest.mark.parametrize("zero_based", [True, False])
def test_make_monotonic_against_numpy(zero_based):
    labels = np.random.default_rng(3).integers(-50, 900, 1000).astype(
        np.int32)
    out, k = native.make_monotonic(labels, zero_based)
    uniq, inv = np.unique(labels, return_inverse=True)
    assert k == len(uniq)
    np.testing.assert_array_equal(out, inv + (0 if zero_based else 1))


@pytest.mark.parametrize("seed", [0, 4])
def test_coo_canonicalize_and_csr_to_ell_against_numpy(seed):
    from raft_tpu_torch.sparse import convert, linalg

    rng = np.random.default_rng(seed)
    m, n, nnz = 80, 50, 600
    r = rng.integers(0, m, nnz)
    c = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz).astype(np.float32)
    v[::17] = 0
    r, c, v = np.r_[r, r[:40]], np.r_[c, c[:40]], np.r_[v, -v[:40]]
    got = native.coo_canonicalize(r, c, v)
    want = convert.canonicalize_numpy(r, c, v, (m, n))
    # the runtime sums duplicates in float64, the twin in float32
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    keep = native.coo_canonicalize(r, c, v, drop_zeros=False)
    assert len(keep[0]) >= len(got[0])
    rows, cols, vals = (np.asarray(a) for a in got)
    indptr = np.r_[0, np.cumsum(np.bincount(rows, minlength=m))]
    vals = vals.astype(np.float32)
    for width in (1, 8, 16):
        for a, b in zip(native.csr_to_ell(indptr, cols, vals, width),
                        linalg.csr_to_ell_numpy(indptr, cols, vals, width)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="malformed"):
        native.csr_to_ell(indptr[::-1].copy(), cols, vals, 8)


def _entry_points():
    """Each native entry point, called through its port caller where it
    has one."""
    import importlib

    sl = importlib.import_module("raft_tpu_torch.cluster.single_linkage")
    from raft_tpu_torch import sparse

    csr = sparse.CSR(np.array([0, 1, 2]), np.array([1, 0]),
                     np.array([1.0, 1.0], np.float32), (2, 2), device="cpu")
    children = np.array([[0, 1]], np.int64)
    return {
        "from_triplets": lambda: sparse.from_triplets(
            [0, 1], [1, 0], [1.0, 1.0], (2, 2), device="cpu"),
        "csr_to_ell": lambda: sparse.csr_to_ell(csr),
        "build_dendrogram_host": lambda: sl.build_dendrogram_host(
            [0], [1], [0.5]),
        "extract_flattened_clusters": lambda: sl.extract_flattened_clusters(
            children, 1, 2),
        "make_monotonic": lambda: native.make_monotonic([3, 1]),
    }


def test_sparse_entry_points_missing_source_raise(monkeypatch, tmp_path):
    calls = _entry_points()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    for name, call in calls.items():
        with pytest.raises(FileNotFoundError, match="missing source"):
            call()
    assert not (tmp_path / "out").exists()


def test_sparse_entry_points_never_fall_back(monkeypatch):
    def broken():
        raise native.NativeBuildError("g++ exited 1")

    calls = _entry_points()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", broken)
    raised = []
    for name, call in calls.items():
        with pytest.raises(native.NativeBuildError):
            call()
        raised.append(name)
    assert len(raised) == 5
