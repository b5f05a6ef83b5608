"""The frozen copies in perf_bench replay the same stream for the same
seed, and the roofline's work counts match hand counts."""

import numpy as np
import pytest
import torch

from perf_bench.counts import ivf_pq_search, peaks
from perf_bench.harness import data, traffic

SPEC = {"kind": "gaussian_mixture", "n_rows": 500, "dim": 16,
        "n_queries": 40, "components": 8, "centres_seed": 11, "sigma": 0.7}


def test_mixture_replays_its_seed():
    a = data.make(SPEC, 2 ** 31 + 7, torch.device("cpu"))
    b = data.make(SPEC, 2 ** 31 + 7, torch.device("cpu"))
    c = data.make(SPEC, 2 ** 31 + 8, torch.device("cpu"))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (500, 16) and a[1].shape == (40, 16)


def test_mixture_is_the_smoke_mixture():
    """Rows are components plus sigma-scaled noise, drawn as chip_smoke's
    ``mixture`` draws them (the component pick, then the noise), around
    centres of the configuration's own seed."""
    comps = torch.randn(8, 16, generator=torch.Generator().manual_seed(11))
    gen = torch.Generator().manual_seed(3)
    pick = torch.randint(0, 8, (500,), generator=gen)
    want = comps[pick] + 0.7 * torch.randn(500, 16, generator=gen)
    x, _ = data.make(SPEC, 3, torch.device("cpu"))
    assert torch.equal(x, want)
    # another seed: other rows around the same centres
    y, _ = data.make(SPEC, 4, torch.device("cpu"))
    assert not torch.equal(x, y)
    assert (x - y).abs().mean() < 2.0


def test_plan_sizes_replay_the_port_generator():
    from raft_tpu_torch.serve import traffic as port

    for seed in (0, 5):
        want = [len(r) for r in port.traffic_requests(
            port.HEAVY_TAIL_PLAN, seed, 300, 4)]
        assert traffic.plan_sizes(traffic.HEAVY_TAIL_PLAN, seed, 300,
                                  4) == want
    assert traffic.HEAVY_TAIL_PLAN == port.HEAVY_TAIL_PLAN


def test_plan_rejects_malformed():
    with pytest.raises(ValueError):
        traffic.parse_plan("band:p=1:lo")
    with pytest.raises(ValueError):
        traffic.parse_plan("surge:at=3")


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 99])
def test_open_traffic_same_seed_same_stream(seed):
    mix = {"kind": "open_poisson", "plan": traffic.HEAVY_TAIL_PLAN,
           "sizes_seed": 0, "rate_qps": 5000}
    a = traffic.make(mix, seed, 3.0, 10000, 128)
    b = traffic.make(mix, seed, 3.0, 10000, 128)
    c = traffic.make(mix, seed + 1, 3.0, 10000, 128)
    assert np.array_equal(a.arrivals, b.arrivals)
    assert all(np.array_equal(u, v) for u, v in zip(a.rows, b.rows))
    # another seed: the same schedule started at another request
    n = len(a.sizes)
    assert n == len(c.sizes) and a.sizes != c.sizes
    shift = next(s for s in range(n)
                 if a.sizes == c.sizes[s:] + c.sizes[:s])
    assert shift > 0
    # the same gaps: all but the one each rotation puts before its start
    ga, gc = np.diff(a.arrivals), np.diff(c.arrivals)
    assert np.isclose(ga[:, None], gc[None], rtol=1e-9).any(1).sum() >= n - 2
    assert abs(sum(a.sizes) / 3.0 - 5000) < 701 / 3.0
    assert np.all(np.diff(a.arrivals) >= 0)
    assert abs(a.arrivals[-1] - 3.0) < 0.2


def test_batch_traffic_takes_the_pool():
    mix = {"kind": "batch", "queries_per_call": 100}
    assert np.array_equal(traffic.make(mix, 3, 1.0, 100, 8).rows,
                          np.arange(100))
    part = traffic.make(mix, 3, 1.0, 1000, 8).rows
    assert len(np.unique(part)) == 100
    assert np.array_equal(part, traffic.make(mix, 3, 1.0, 1000, 8).rows)


def test_ivf_pq_counts_match_hand_counts():
    # 4 queries of dim 2, 3 lists: queries next to centres 0 and 2
    c = torch.tensor([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]])
    q = torch.tensor([[0.1, 0.0], [0.0, 0.2], [0.0, 9.9], [0.2, 9.8]])
    sizes = torch.tensor([5, 7, 11])
    w = ivf_pq_search.work(q, c, sizes, rot_dim=2, pq_dim=1, pq_bits=4,
                           n_probes=1, k=2)
    rows = 5 + 11                     # lists 0 and 2 probed, list 1 not
    by_hand = (4 * 4 * 2 + 4 * 3 * 2 + 4 * 2 * 2 + 4 * 16 * 2
               + rows * (1 + 4) + 8 * 4 * 2)
    assert w["bytes"] == by_hand
    assert w["flop"] == 2 * 4 * 3 * 2 + 2 * 4 * 2 * 2 + 2 * 4 * 2 * 16
    assert w["least_s"] == max(w["flop"] / peaks.F32_ACCURATE_FLOP_PER_S,
                               w["bytes"] / peaks.HBM_BYTES_PER_S)
    assert w["bound"] == "bytes"
