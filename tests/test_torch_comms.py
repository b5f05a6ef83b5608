"""The port's communicator against the JAX package's on the same inputs.

The port side runs as a gloo world of W processes (one battery per world,
``raft_tpu_torch.testing.world``); the JAX side runs the same operations
under ``shard_map`` over a mesh of W of the conftest's CPU devices.
Every collective, ``comm_split`` (keys, unequal groups), ``replica_split``,
the ``collective_calls`` counts and bytes, ``sync_stream`` after an abort
and every ``self_tests`` check, at W = 1, 2 and 4.  What moves or selects
values agrees bit for bit; a SUM or PROD over several ranks may add in
another order (gloo's ring against XLA's), so those agree to float32
rounding (:data:`RTOL`).  This module imports no JAX at its top: its
batteries run in the world's processes.
"""

import numpy as np
import pytest
import torch

WORLDS = (1, 2, 4)
#: the world-communicator operations of the battery, in call order
OPS = ("allreduce_sum", "allreduce_prod", "allreduce_min", "allreduce_max",
       "bcast_last", "bcast_bool", "reduce", "allgather", "allgatherv",
       "gather", "gatherv", "reducescatter_sum", "reducescatter_max",
       "sendrecv_ring", "sendrecv_pair", "multicast", "multicast_one")
SELF_TESTS = ("test_collective_allreduce", "test_collective_broadcast",
              "test_collective_reduce", "test_collective_allgather",
              "test_collective_gather", "test_collective_gatherv",
              "test_collective_reducescatter",
              "test_pointToPoint_device_sendrecv",
              "test_pointToPoint_device_multicast_sendrecv",
              "test_pointToPoint_simple_send_recv", "test_commsplit")
#: the 2×2 split: colors by parity, keys reversing the rank order
SPLIT_COLORS, SPLIT_KEYS = [0, 1, 0, 1], [3, 2, 1, 0]
UNEQUAL_COLORS = [0, 0, 0, 1]
#: the operations that add or multiply across ranks, and their tolerance
#: (a few float32 roundings of values of order 1)
ARITH = ("allreduce_sum", "allreduce_prod", "reduce", "reducescatter_sum")
RTOL, ATOL = 1e-6, 1e-6


def _inputs(world: int) -> dict:
    rng = np.random.default_rng(100 + world)
    return {"x": rng.standard_normal((world, 5)).astype(np.float32),
            "y": rng.standard_normal((world, 3 * world, 2)).astype(
                np.float32)}


def _world_ops(c, x, y, n, ops):
    """The battery's world operations, through the port's (torch) or the
    JAX package's communicator API (*ops* supplies the array helpers)."""
    counts = [i + 1 for i in range(n)]
    r = ops.rank()
    return {
        "allreduce_sum": lambda: c.allreduce(x, ops.SUM),
        "allreduce_prod": lambda: c.allreduce(x, ops.PROD),
        "allreduce_min": lambda: c.allreduce(x, ops.MIN),
        "allreduce_max": lambda: c.allreduce(x, ops.MAX),
        "bcast_last": lambda: c.bcast(x, root=n - 1),
        "bcast_bool": lambda: c.bcast(x > 0, root=0),
        "reduce": lambda: c.reduce(x, root=0),
        "allgather": lambda: c.allgather(x),
        "allgatherv": lambda: c.allgatherv(ops.head(x, r + 1, 5), counts,
                                           pad_to=5)[0],
        "gather": lambda: c.gather(x, root=0),
        "gatherv": lambda: c.gatherv(ops.head(x, r + 1, n), counts)[0],
        "reducescatter_sum": lambda: c.reducescatter(y, ops.SUM),
        "reducescatter_max": lambda: c.reducescatter(y, ops.MAX),
        "sendrecv_ring": lambda: c.device_sendrecv(
            x, [(i, (i + 1) % n) for i in range(n)]),
        "sendrecv_pair": lambda: c.device_sendrecv(x, [(0, n - 1)]),
        "multicast": lambda: c.device_multicast_sendrecv(
            x, dsts=list(range(n)), srcs=[n - 1, 0]),
        "multicast_one": lambda: c.device_multicast_sendrecv(
            x, dsts=[0], srcs=[0]),
    }


class _TorchOps:
    def __init__(self, comms):
        from raft_tpu_torch.comms import ReduceOp

        self.SUM, self.PROD = ReduceOp.SUM, ReduceOp.PROD
        self.MIN, self.MAX = ReduceOp.MIN, ReduceOp.MAX
        self._rank = comms.get_rank()

    def rank(self):
        return self._rank

    @staticmethod
    def head(x, m, cap):
        # rank r contributes its first r + 1 values (allgatherv pads them)
        return x[:m]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else t


def _battery(comms, payload):
    """Every rank: the world operations, the counters after them, the
    splits, sync_stream and the self-tests."""
    from raft_tpu_torch.comms import Status, self_tests
    from raft_tpu_torch.core.error import LogicError

    n, r = comms.get_size(), comms.get_rank()
    x = torch.from_numpy(payload["x"][r])
    y = torch.from_numpy(payload["y"][r])
    out = {name: _np(fn()) for name, fn in _world_ops(
        comms, x, y, n, _TorchOps(comms)).items()}
    out["calls"] = dict(comms.collective_calls)
    out["size_rank"] = (comms.get_size(), comms.get_rank(),
                        comms.get_global_rank())
    if n == 4:
        sub = comms.comm_split(SPLIT_COLORS, SPLIT_KEYS)
        half = y[:6]
        out["split"] = {"size_rank": (sub.get_size(), sub.get_rank()),
                        "allreduce": _np(sub.allreduce(x)),
                        "allgather": _np(sub.allgather(x)),
                        "bcast": _np(sub.bcast(x, root=0)),
                        "reducescatter": _np(sub.reducescatter(half))}
        uneq = comms.comm_split(UNEQUAL_COLORS)
        refused = {}
        for name, fn in (("allgather", lambda: uneq.allgather(x)),
                         ("reducescatter", lambda: uneq.reducescatter(y))):
            try:
                fn()
                refused[name] = False
            except LogicError:
                refused[name] = True
        out["unequal"] = {"size": uneq.get_size(),
                          "allreduce": _np(uneq.allreduce(x)),
                          "refused": refused}
        layout = comms.replica_split(2)
        mine = layout.groups[r // layout.group_size]
        out["replica"] = {
            "group_size": layout.group_size,
            "split_allreduce": _np(layout.split.allreduce(x)),
            "group_allreduce": _np(mine.allreduce(x)),
            "group_size_rank": (mine.get_size(), mine.get_rank()),
            "group_calls": mine.collective_calls["allreduce"]}
    if n == 1:
        from raft_tpu_torch import telemetry

        fleet = telemetry.gather(comms)
        out["fleet"] = (fleet["world"], sorted(fleet["hosts"]),
                         fleet["partial"],
                         fleet["rollup"] == telemetry.merge(
                             [fleet["hosts"]["0"]]))
    out["self_tests"] = self_tests.run_all(comms)
    status = [comms.sync_stream()]
    comms.abort()
    status += [comms.sync_stream(), comms.sync_stream()]
    out["sync"] = [s == Status.SUCCESS for s in status]
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    from raft_tpu_torch.testing.world import run_world

    tests = str(__import__("pathlib").Path(__file__).parent)
    return {w: run_world("test_torch_comms:_battery", w, _inputs(w),
                         workdir=tmp_path_factory.mktemp(f"world{w}"),
                         sys_path=[tests], timeout=120)
            for w in WORLDS}


class _JaxOps:
    def __init__(self, comms):
        from raft_tpu.comms import ReduceOp

        self.SUM, self.PROD = ReduceOp.SUM, ReduceOp.PROD
        self.MIN, self.MAX = ReduceOp.MIN, ReduceOp.MAX
        self._comms = comms

    def rank(self):
        return self._comms.get_rank()

    @staticmethod
    def head(x, m, cap):
        import jax.numpy as jnp

        # static shapes: *cap* values, the first m kept and the rest
        # zeroed — what the port's allgatherv pads its m values to
        return jnp.where(jnp.arange(cap) < m, x[:cap], 0.0)


def _jax_comms(world):
    from jax.sharding import Mesh

    import jax
    from raft_tpu.comms import build_comms

    return build_comms(Mesh(np.array(jax.devices()[:world]), ("world",)))


def _jax_per_rank(comms, fn, *arrays):
    """fn(*this rank's slices) under shard_map; returns (W, ...) numpy."""
    from jax.sharding import PartitionSpec as P

    spec = P(comms.axis_name)

    def body(*shards):
        return fn(*(s[0] for s in shards))[None]

    return np.asarray(comms.run(body, *arrays,
                                in_specs=tuple(spec for _ in arrays),
                                out_specs=spec))


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for w in WORLDS:
        comms = _jax_comms(w)
        data = _inputs(w)
        res = {}
        for name in OPS:
            def one(x, y, name=name):
                return _world_ops(comms, x, y, w, _JaxOps(comms))[name]()

            res[name] = _jax_per_rank(comms, one, data["x"], data["y"])
        res["calls"] = dict(comms.collective_calls)
        out[w] = (comms, res)
    return out


@pytest.mark.parametrize("name", OPS)
@pytest.mark.parametrize("world", WORLDS)
def test_collective_matches_jax(port, jax_side, world, name):
    want = jax_side[world][1][name]
    for r in range(world):
        got = port[world][r][name]
        assert got.dtype == want[r].dtype and got.shape == want[r].shape, (
            name, got.dtype, got.shape, want[r].dtype, want[r].shape)
        if name in ARITH:
            np.testing.assert_allclose(got, want[r], rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r}")
        else:
            np.testing.assert_array_equal(got, want[r], err_msg=f"rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_collective_calls_count_and_bytes(port, jax_side, world):
    """One count a call and the per-rank payload bytes, as the JAX
    package counts one a traced call (each operation here is traced
    once); device p2p is not counted on either side.  The JAX package
    lowers a non-SUM reducescatter to an allreduce and a slice and counts
    that allreduce too; the port's is one reduce-scatter."""
    want = dict(jax_side[world][1]["calls"])
    y_bytes = 3 * world * 2 * 4
    want["allreduce"] -= 1
    want["allreduce_bytes"] -= y_bytes
    for r in range(world):
        assert port[world][r]["calls"] == want
    x_bytes = 5 * 4
    assert want["allreduce"] == 5 and want["bcast"] == 2
    assert want["allgather"] == 4 and want["reducescatter"] == 2
    # gatherv pads to max(counts) = world values
    assert want["allgather_bytes"] == 3 * x_bytes + 4 * world
    assert want["reducescatter_bytes"] == 2 * y_bytes


@pytest.mark.parametrize("world", WORLDS)
def test_size_and_ranks(port, world):
    for r in range(world):
        assert port[world][r]["size_rank"] == (world, r, r)


def test_split_with_keys_matches_jax(port):
    """2×2 split with keys reversing the order: color 0 holds [2, 0],
    color 1 holds [3, 1] (key order)."""
    from raft_tpu.comms import ReduceOp

    comms = _jax_comms(4)
    sub = comms.comm_split(SPLIT_COLORS, SPLIT_KEYS)
    data = _inputs(4)
    want = {
        "allreduce": _jax_per_rank(
            comms, lambda x: sub.allreduce(x, ReduceOp.SUM), data["x"]),
        "allgather": _jax_per_rank(comms, sub.allgather, data["x"]),
        "bcast": _jax_per_rank(comms, lambda x: sub.bcast(x, 0), data["x"]),
        "reducescatter": _jax_per_rank(
            comms, lambda y: sub.reducescatter(y[:6]), data["y"]),
    }
    for r in range(4):
        got = port[4][r]["split"]
        assert got["size_rank"] == (2, {0: 1, 1: 1, 2: 0, 3: 0}[r])
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w[r], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} rank {r}")
    # key order: color 0's gather is [rank 2, rank 0]
    np.testing.assert_array_equal(port[4][0]["split"]["allgather"],
                                  data["x"][[2, 0]])


def test_unequal_split_allreduce_works_shape_changers_refuse(port):
    from raft_tpu.comms import ReduceOp
    from raft_tpu.core.error import LogicError

    comms = _jax_comms(4)
    sub = comms.comm_split(UNEQUAL_COLORS)
    data = _inputs(4)
    want = _jax_per_rank(comms, lambda x: sub.allreduce(x, ReduceOp.SUM),
                         data["x"])
    for name, fn in (("allgather", sub.allgather),
                     ("reducescatter", sub.reducescatter)):
        with pytest.raises(LogicError):
            _jax_per_rank(comms, fn, data["y"])
    for r in range(4):
        got = port[4][r]["unequal"]
        assert got["size"] == (3 if r < 3 else 1)
        np.testing.assert_allclose(got["allreduce"], want[r], rtol=RTOL,
                                   atol=ATOL)
        assert got["refused"] == {"allgather": True, "reducescatter": True}


def test_replica_split_matches_jax(port):
    from raft_tpu.comms import ReduceOp

    comms = _jax_comms(4)
    layout = comms.replica_split(2)
    data = _inputs(4)
    split = _jax_per_rank(comms, lambda x: layout.split.allreduce(
        x, ReduceOp.SUM), data["x"])
    groups = np.concatenate([
        _jax_per_rank(g, lambda x, g=g: g.allreduce(x, ReduceOp.SUM),
                      data["x"][2 * i:2 * i + 2])
        for i, g in enumerate(layout.groups)])
    for r in range(4):
        got = port[4][r]["replica"]
        assert got["group_size"] == layout.group_size == 2
        assert got["group_size_rank"] == (2, r % 2)
        assert got["group_calls"] == 1
        np.testing.assert_allclose(got["split_allreduce"], split[r],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["group_allreduce"], groups[r],
                                   rtol=RTOL, atol=ATOL)


def test_world_of_one_gathers_its_own_snapshot(port):
    assert port[1][0]["fleet"] == (1, ["0"], False, True)


@pytest.mark.parametrize("world", WORLDS)
def test_sync_stream_abort_is_sticky(port, world):
    for r in range(world):
        assert port[world][r]["sync"] == [True, False, False]


@pytest.mark.parametrize("check", SELF_TESTS)
@pytest.mark.parametrize("world", WORLDS)
def test_self_tests_hold_on_both(port, jax_side, world, check):
    from raft_tpu.comms import self_tests

    assert getattr(self_tests, check)(jax_side[world][0])
    for r in range(world):
        assert port[world][r]["self_tests"][check] is True


_SESSION_SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
from raft_tpu_torch.comms import CommsSession, get_comms_state, local_handle
from raft_tpu_torch.core.error import LogicError

out = {}
try:
    CommsSession(n_devices=2, device="cpu").init()
    out["n_devices_2"] = "ran"
except LogicError as e:
    out["n_devices_2"] = "one process per rank" in str(e)
with CommsSession(device="cpu", session_id="s1") as s:
    h = local_handle("s1")
    out["handle"] = (h is not None and h.comms_initialized()
                     and h.get_comms() is s.comms)
    out["backend"] = s.comms.backend
    out["world"] = dist.get_world_size()
    out["info"] = s.worker_info()
    out["sub"] = float(s.comms.comm_split([0]).allreduce(torch.ones(())))
    out["state"] = sorted(get_comms_state("s1"))
out["after"] = [dist.is_initialized(), local_handle("s1") is None]
# a session over a group it did not create destroys only its own groups
dist.init_process_group("gloo", init_method=f"file://{sys.argv[1]}/w",
                        world_size=1, rank=0)
s = CommsSession(device="cpu").init()
s.comms.comm_split([0])
s.destroy()
out["existing_kept"] = dist.is_initialized()
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_session_lifecycle(tmp_path):
    """CommsSession in a process of its own (the default process group is
    process-global): the world of one over a FileStore, local_handle, the
    handle's comms, worker_info, destroy."""
    import json
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _SESSION_SCRIPT,
                          str(tmp_path)], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"n_devices_2": True, "handle": True, "backend": "gloo",
                   "world": 1, "info": {"0": {"rank": 0, "device": "cpu"}},
                   "sub": 1.0, "state": ["comms", "handle", "nranks"],
                   "after": [False, True], "existing_kept": True}


def test_handle_comms_slots():
    from raft_tpu_torch.comms import as_comms
    from raft_tpu_torch.core.error import LogicError
    from raft_tpu_torch.core.handle import Handle

    h = Handle(device="cpu")
    assert not h.comms_initialized()
    with pytest.raises(LogicError, match="Communicator was not initialized"):
        h.get_comms()
    with pytest.raises(LogicError, match="Subcommunicator rows was never"):
        h.get_subcomm("rows")
    marker = object()
    h.set_comms(marker)
    h.set_subcomm("rows", marker)
    assert h.comms_initialized() and h.get_comms() is marker
    assert h.get_subcomm("rows") is marker and as_comms(h) is marker
