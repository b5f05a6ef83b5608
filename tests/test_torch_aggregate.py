"""Fleet telemetry: the port's ``merge`` against the JAX package's on the
same snapshot dicts, merge against one histogram of the union stream, and
``gather`` over a gloo world of 3 processes with the degradation contract
(an injected ``comms`` fault on one rank's ``isend``)."""

import json
import pathlib

import numpy as np
import pytest

from raft_tpu_torch import telemetry
from raft_tpu_torch.telemetry import aggregate
from raft_tpu_torch.telemetry.export import snapshot
from raft_tpu_torch.telemetry.registry import Registry


def _streams(rng, n_shards):
    """Per-shard latency streams over the histogram's whole scale, with
    under- and overflow values on shard 0."""
    out = []
    for s in range(n_shards):
        vals = np.exp(rng.normal(rng.uniform(-10, -1), 1.2,
                                 rng.integers(200, 2000)))
        if s == 0:
            vals = np.concatenate([vals, [1e-9, 500.0]])
        out.append(vals)
    return out


def _shard_snapshots(streams):
    snaps = []
    for s, vals in enumerate(streams):
        reg = Registry()
        h = reg.histogram("t_agg_lat", "t", labelnames=("shard",))
        for v in vals:
            h.observe(float(v), ("s",))
        reg.counter("t_agg_reqs", "t").inc(len(vals))
        reg.gauge("t_agg_g", "t", ("fn",)).set(float(s), ("a",))
        reg.gauge("t_agg_g", "t", ("fn",)).set(float(-s), (f"b{s}",))
        snaps.append(snapshot(registry=reg))
    return snaps


def test_geometry_is_the_jax_packages():
    from raft_tpu import telemetry as jt

    assert (telemetry.HIST_MIN, telemetry.HIST_MAX, telemetry.HIST_BUCKETS
            ) == (jt.HIST_MIN, jt.HIST_MAX, jt.HIST_BUCKETS) == (
                1e-6, 100.0, 64)
    assert [telemetry.bucket_upper(i) for i in range(64)] == [
        jt.bucket_upper(i) for i in range(64)]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_merge_equals_jax_merge(seed):
    from raft_tpu.telemetry import aggregate as jagg

    snaps = _shard_snapshots(_streams(np.random.default_rng(seed), 4))
    got = aggregate.merge(snaps)
    assert got == jagg.merge(snaps)
    assert json.loads(json.dumps(got)) == got


def test_merge_equals_union_stream():
    """Bucket-exact against one histogram observing the union: the same
    counts per bucket, count, min and max; the sum to reassociation."""
    streams = _streams(np.random.default_rng(21), 5)
    merged = aggregate.merge(_shard_snapshots(streams))
    reg = Registry()
    h = reg.histogram("t_agg_lat", "t", labelnames=("shard",))
    for vals in streams:
        for v in vals:
            h.observe(float(v), ("s",))
    union = snapshot(registry=reg)["t_agg_lat"]["values"]["shard=s"]
    cell = merged["t_agg_lat"]["values"]["shard=s"]
    for key in ("buckets", "count", "min", "max", "p50", "p99"):
        assert cell[key] == union[key], key
    assert cell["sum"] == pytest.approx(union["sum"], rel=1e-12)
    assert merged["t_agg_reqs"]["values"][""] == sum(map(len, streams))


def test_counters_sum_gauges_max_labels_union():
    merged = aggregate.merge(_shard_snapshots(
        _streams(np.random.default_rng(5), 3)))
    assert merged["t_agg_g"]["values"] == {
        "fn=a": 2.0, "fn=b0": 0.0, "fn=b1": -1.0, "fn=b2": -2.0}


def test_type_mismatch_raises():
    ra, rb = Registry(), Registry()
    ra.counter("t_agg_clash", "t").inc(1)
    rb.gauge("t_agg_clash", "t").set(1.0)
    with pytest.raises(ValueError, match="disagrees"):
        aggregate.merge([snapshot(registry=ra), snapshot(registry=rb)])


def test_off_grid_bucket_raises():
    reg = Registry()
    reg.histogram("t_agg_grid", "t").observe(1e-3)
    snap = snapshot(registry=reg)
    snap["t_agg_grid"]["values"][""]["buckets"][0][0] += 1e-3
    with pytest.raises(ValueError, match="grid"):
        aggregate.merge([snap, snap])


def _gather_battery(comms, payload):
    """Every rank: the collective fault site, then gather with rank 1's
    host-plane sends failing, non-strict and strict."""
    import torch

    from raft_tpu_torch.core.error import LogicError
    from raft_tpu_torch.testing import faults

    out = {}
    telemetry.counter("t_agg_world_marker").inc(comms.get_rank() + 1)
    with faults.plan("comms:op=allreduce:n=1:raise"):
        try:
            comms.allreduce(torch.ones(2))
            out["allreduce_fault"] = False
        except faults.InjectedFault:
            out["allreduce_fault"] = True
        # n=1: the next allreduce goes through
        out["allreduce_after"] = float(comms.allreduce(torch.ones(())))
    with faults.plan("comms:rank=1:op=isend:raise"):
        fleet = telemetry.gather(comms, timeout=payload["timeout"])
        out["fleet"] = {k: fleet[k] for k in ("world", "partial",
                                              "missing_ranks")}
        out["hosts"] = sorted(fleet["hosts"])
        out["marker"] = fleet["rollup"]["t_agg_world_marker"]["values"][""]
        out["aborted"] = comms._aborted
        try:
            telemetry.gather(comms, timeout=payload["timeout"], strict=True)
            out["strict"] = "returned"
        except (LogicError, faults.InjectedFault) as e:
            out["strict"] = type(e).__name__
    return out


@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    from raft_tpu_torch.comms.hostcomm import MailboxServer
    from raft_tpu_torch.testing.world import run_world

    with MailboxServer() as server:
        coord = f"{server.address[0]}:{server.address[1]}"
        return run_world("test_torch_aggregate:_gather_battery", 3,
                         {"timeout": 2.0},
                         workdir=tmp_path_factory.mktemp("gather"),
                         coordinator=coord, timeout=120,
                         sys_path=[str(pathlib.Path(__file__).parent)])


def test_collective_fault_site_fires(gathered):
    for out in gathered:
        assert out["allreduce_fault"] is True
        assert out["allreduce_after"] == 3.0


def test_gather_degrades_to_partial_rollup(gathered):
    """Ranks 0 and 2 never hear from rank 1: partial, rank 1 missing, the
    rollup of what arrived, and the communicator not aborted.  Rank 1
    hears from both others."""
    for rank in (0, 2):
        out = gathered[rank]
        assert out["fleet"] == {"world": 3, "partial": True,
                                "missing_ranks": [1]}
        assert out["hosts"] == ["0", "2"]
        assert out["marker"] == 1 + 3  # ranks 0 and 2 counted 1 and 3
        assert out["aborted"] is False
    out = gathered[1]
    assert out["fleet"] == {"world": 3, "partial": False,
                            "missing_ranks": []}
    assert out["hosts"] == ["0", "1", "2"] and out["marker"] == 6
    assert out["aborted"] is False


def test_strict_gather_raises(gathered):
    assert gathered[1]["strict"] == "InjectedFault"
    assert gathered[0]["strict"] == gathered[2]["strict"] == "LogicError"
