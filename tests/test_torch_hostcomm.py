"""The port's host p2p plane over its threaded Python server (the native
one: ``test_torch_native.py``): its mailbox client against the JAX
package's server and the JAX client against the port's (the wire protocol
byte for byte), FIFO per tag, tags that do not cross, a large payload, and
``host_barrier`` and tagged ``isend`` / ``waitall`` across a gloo world of
two processes."""

import pathlib
import pickle
import time

import numpy as np
import pytest

from raft_tpu_torch.comms import hostcomm


@pytest.fixture
def jax_python_server(monkeypatch):
    from raft_tpu.comms import hostcomm as jhost

    monkeypatch.setenv("RAFT_TPU_NATIVE_MAILBOX", "0")
    with jhost.MailboxServer() as server:
        assert server.backend == "python"
        yield f"{server.address[0]}:{server.address[1]}"


@pytest.fixture
def port_server():
    with hostcomm.MailboxServer(backend="python") as server:
        assert server.backend == "python"
        yield f"{server.address[0]}:{server.address[1]}"


def test_request_encoding_is_byte_identical():
    from raft_tpu.comms import hostcomm as jhost

    payload = pickle.dumps({"a": np.arange(3)})
    for op in (1, 2):
        for args in ((b"sess", 0, 3, 7, 1.5), (b"", 5, -1, -0xB0B, 60.0)):
            assert (hostcomm._encode_req(op, *args, payload)
                    == jhost._encode_req(op, *args, payload))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_port_client_against_jax_server(jax_python_server, direction):
    from raft_tpu.comms import hostcomm as jhost

    port = hostcomm.TcpMailbox(jax_python_server, "s", 0)
    jax = jhost.TcpMailbox(jax_python_server, "s", 1)
    src, dst = (port, jax) if direction == "port_to_jax" else (jax, port)
    src.put(dst=dst.rank, tag=3, obj={"ids": np.arange(5, dtype=np.int32)})
    got = dst.get(src=src.rank, tag=3, timeout=10)
    np.testing.assert_array_equal(got["ids"], np.arange(5))
    with pytest.raises(TimeoutError):
        dst.get(src=src.rank, tag=99, timeout=0.2)
    port.close()
    jax.close()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_jax_client_against_port_server(port_server, direction):
    from raft_tpu.comms import hostcomm as jhost

    port = hostcomm.TcpMailbox(port_server, "s", 0)
    jax = jhost.TcpMailbox(port_server, "s", 1)
    src, dst = (port, jax) if direction == "port_to_jax" else (jax, port)
    src.put(dst=dst.rank, tag=-4, obj=("hello", 2.5))
    assert dst.get(src=src.rank, tag=-4, timeout=10) == ("hello", 2.5)
    port.close()
    jax.close()


def test_fifo_per_tag_and_tags_do_not_cross(port_server):
    a = hostcomm.TcpMailbox(port_server, "fifo", 0)
    b = hostcomm.TcpMailbox(port_server, "fifo", 1)
    for i in range(50):
        a.put(dst=1, tag=i % 3, obj=i)
    for tag in (2, 0, 1):
        assert [b.get(0, tag, 5) for _ in range(50 // 3 + (tag < 50 % 3))
                ] == list(range(tag, 50, 3))
    a.put(dst=1, tag=5, obj="only tag 5")
    with pytest.raises(TimeoutError):
        b.get(0, 6, 0.2)
    # another session never sees it either
    with pytest.raises(TimeoutError):
        hostcomm.TcpMailbox(port_server, "other", 1).get(0, 5, 0.2)
    assert b.get(0, 5, 5) == "only tag 5"


def test_large_payload_round_trip(port_server):
    big = np.random.default_rng(0).standard_normal(3_000_000).astype(
        np.float32)                                         # 12 MB
    a = hostcomm.TcpMailbox(port_server, "big", 0)
    b = hostcomm.TcpMailbox(port_server, "big", 1)
    a.put(dst=1, tag=0, obj=big)
    np.testing.assert_array_equal(b.get(0, 0, 30), big)


def test_default_coordinator_reads_the_environment(monkeypatch):
    monkeypatch.delenv("RAFT_TPU_COORD_ADDR", raising=False)
    assert hostcomm.default_coordinator() is None
    monkeypatch.setenv("RAFT_TPU_COORD_ADDR", "127.0.0.1:4321")
    assert hostcomm.default_coordinator() == "127.0.0.1:4321"


def _barrier_battery(comms, payload):
    """Every rank: three barriers (rank 1 arrives late to the second),
    then a tagged exchange with every other rank over the comms."""
    rank, world = comms.get_rank(), comms.get_size()
    times = []
    for i in range(3):
        if i == 1 and rank == 1:
            time.sleep(payload["late_s"])
        enter = time.time()
        hostcomm.host_barrier(comms._mailbox, rank, world, timeout=30)
        times.append((enter, time.time()))
    for r in range(world):
        if r != rank:
            comms.isend({"from": rank, "to": r}, dst=r, tag=11)
    got = comms.waitall([comms.irecv(r, 11) for r in range(world)
                         if r != rank], timeout=30)
    return {"times": times, "got": got}


def test_host_barrier_across_two_processes(port_server, tmp_path):
    from raft_tpu_torch.testing.world import run_world

    late = 0.5
    out = run_world("test_torch_hostcomm:_barrier_battery", 2,
                    {"late_s": late}, workdir=tmp_path,
                    coordinator=port_server, timeout=120,
                    sys_path=[str(pathlib.Path(__file__).parent)])
    # rank 0 cannot leave the second barrier before rank 1 entered it
    assert out[0]["times"][1][1] >= out[1]["times"][1][0]
    assert out[0]["times"][1][1] - out[0]["times"][1][0] >= 0.8 * late
    assert out[0]["got"] == [{"from": 1, "to": 0}]
    assert out[1]["got"] == [{"from": 0, "to": 1}]
