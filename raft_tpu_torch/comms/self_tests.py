"""Comms self-tests: sanity checks runnable on whatever comms a handle holds
(port of ``raft_tpu/comms/self_tests.py``; reference
raft/comms/comms_test.hpp:35-168, functions raft-dask drives on every
worker).

Each check is a per-rank function: every rank of the communicator calls
it, and it returns True on every rank when it held on every rank (the
ranks agree through a MIN allreduce, as in the JAX package).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.comms.comms import Comms
from raft_tpu_torch.comms.comms_types import ReduceOp


def _agree(comms: Comms, ok) -> bool:
    """True iff *ok* held on every rank."""
    flag = torch.as_tensor(bool(ok), dtype=torch.int32, device=comms.device)
    return int(comms.allreduce(flag, ReduceOp.MIN)) == 1


def _rank_value(comms: Comms) -> torch.Tensor:
    return torch.tensor(float(comms.get_global_rank()), device=comms.device)


def test_collective_allreduce(comms: Comms) -> bool:
    """reference comms_test.hpp:35 — allreduce of 1 == size."""
    out = comms.allreduce(torch.ones((), device=comms.device))
    return _agree(comms, int(out) == comms.get_size())


def test_collective_broadcast(comms: Comms) -> bool:
    """reference comms_test.hpp:55 — root's value lands everywhere."""
    got = comms.bcast(_rank_value(comms) + 1, root=0)
    return _agree(comms, float(got) == comms.ranks[0] + 1.0)


def test_collective_reduce(comms: Comms) -> bool:
    n = comms.get_size()
    got = comms.reduce(_rank_value(comms), root=0, op=ReduceOp.SUM)
    return _agree(comms, float(got) == n * (n - 1) / 2)


def test_collective_allgather(comms: Comms) -> bool:
    g = comms.allgather(_rank_value(comms)[None])
    want = torch.arange(comms.get_size(), dtype=torch.float32,
                        device=comms.device)
    return _agree(comms, torch.equal(g.reshape(-1), want))


def test_collective_gather(comms: Comms) -> bool:
    g = comms.gather(_rank_value(comms)[None], root=0)
    want = torch.arange(comms.get_size(), dtype=torch.float32,
                        device=comms.device)
    return _agree(comms, torch.equal(g.reshape(-1), want))


def test_collective_gatherv(comms: Comms) -> bool:
    """Variable counts: rank r contributes r + 1 values (reference
    comms_test.hpp gatherv test shape)."""
    n = comms.get_size()
    counts = [r + 1 for r in range(n)]
    rank = comms.get_rank()
    mine = torch.full((counts[rank],), float(rank), device=comms.device)
    g, _ = comms.gatherv(mine, counts)
    return _agree(comms, all(bool((g[r, :counts[r]] == float(r)).all())
                             for r in range(n)))


def test_collective_reducescatter(comms: Comms) -> bool:
    """reference comms_test.hpp:150 — each rank receives the reduced
    chunk."""
    n = comms.get_size()
    got = comms.reducescatter(torch.ones((n,), device=comms.device))
    return _agree(comms, bool((got == float(n)).all()))


def test_pointToPoint_device_sendrecv(comms: Comms) -> bool:
    """Ring exchange (reference device_sendrecv tests, comms_test.hpp)."""
    n = comms.get_size()
    perm = [(i, (i + 1) % n) for i in range(n)]
    got = comms.device_sendrecv(_rank_value(comms), perm)
    return _agree(comms, float(got) == float((comms.get_global_rank() - 1)
                                             % n))


def test_pointToPoint_device_multicast_sendrecv(comms: Comms) -> bool:
    n = comms.get_size()
    srcs = list(range(n))
    got = comms.device_multicast_sendrecv(_rank_value(comms), dsts=srcs,
                                          srcs=srcs)
    return _agree(comms, torch.equal(
        got, torch.arange(n, dtype=torch.float32, device=comms.device)))


def test_pointToPoint_simple_send_recv(comms: Comms) -> bool:
    """Host p2p plane: tagged send/recv roundtrip (UCX's role in the
    reference, comms_test.hpp:100)."""
    payload = {"hello": 42}
    req_s = comms.isend(payload, dst=comms._host_rank, tag=7)
    req_r = comms.irecv(src=comms._host_rank, tag=7)
    (got,) = comms.waitall([req_s, req_r], timeout=5)
    return _agree(comms, got == payload)


def test_commsplit(comms: Comms) -> bool:
    """reference comms_test.hpp:168 — split into two halves; allreduce
    within each half sums only that half's ranks."""
    n = comms.get_size()
    if n < 2:
        return True
    half = n // 2
    sub = comms.comm_split([0] * half + [1] * (n - half))
    cnt = sub.allreduce(torch.ones((), device=comms.device))
    mysum = sub.allreduce(_rank_value(comms))
    rank = comms.get_global_rank()
    exp_cnt = float(half) if rank < half else float(n - half)
    exp_sum = (half * (half - 1) / 2 if rank < half
               else float(sum(range(half, n))))
    return _agree(comms, float(cnt) == exp_cnt and float(mysum) == exp_sum)


ALL_TESTS = [
    test_collective_allreduce,
    test_collective_broadcast,
    test_collective_reduce,
    test_collective_allgather,
    test_collective_gather,
    test_collective_gatherv,
    test_collective_reducescatter,
    test_pointToPoint_device_sendrecv,
    test_pointToPoint_device_multicast_sendrecv,
    test_pointToPoint_simple_send_recv,
    test_commsplit,
]


def run_all(comms: Comms) -> dict:
    """Run the full suite on every rank; returns {test_name: bool}."""
    return {t.__name__: t(comms) for t in ALL_TESTS}
