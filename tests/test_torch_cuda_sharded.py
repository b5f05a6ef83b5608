"""Sharded and replicated serving on the card: a world of one over NCCL
(``build_sharded`` bit for bit ``build().shard()`` for both IVF families;
the sharded engine's results bit for bit the single-device engine's, in
float32 and bfloat16 requests) and a world of two gloo processes on the
one card (the sharded IVF-PQ engine and the R = 2 replica engine with
rank 0 leading: results bit for bit the single-device engine's, both
replica lanes serving, the fault plan draining lane 1 with no failed
request; kernels B1, B2, B3 and B4's scan mode launched).

These tests need an NVIDIA card (marker ``cuda``) and skip without one;
run them with
``python -m pytest --noconftest tests/test_torch_cuda_sharded.py -q -m cuda``.
"""

import pathlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

N, D, NQ, K, N_LISTS = 50_000, 32, 600, 10, 64
SIZES = (1, 7, 64, 300, 33, 128, 67)


def _data(device):
    gen = torch.Generator(device=device).manual_seed(5)
    c = torch.randn(64, D, generator=gen, device=device)
    x = c[torch.randint(0, 64, (N,), generator=gen, device=device)] \
        + 0.7 * torch.randn(N, D, generator=gen, device=device)
    q = c[torch.randint(0, 64, (NQ,), generator=gen, device=device)] \
        + 0.7 * torch.randn(NQ, D, generator=gen, device=device)
    return x, q.cpu()


def _requests(q, dtype=torch.float32):
    out, start = [], 0
    for n in SIZES:
        out.append(q[start:start + n].to(dtype))
        start += n
    return out


def _single(index, params, reqs):
    from raft_tpu_torch.serve import ServeEngine

    eng = ServeEngine(index, K, params, max_batch=256)
    eng.warmup(dtypes=(torch.float32, torch.bfloat16))
    out = [tuple(r) for r in eng.search(reqs)]
    eng.close()
    return out


def _battery(comms, payload):
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ann_mnmg, ivf_flat, ivf_pq
    from raft_tpu_torch.serve import ServeEngine
    from raft_tpu_torch.testing import faults

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = comms.device
    x, q = _data(dev)
    reqs = _requests(q)
    out = {}
    native.reset_launches()
    fams = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq}
    built = {}
    for kind, mod in fams.items():
        params = mod.IndexParams(n_lists=N_LISTS)
        index = mod.build(params, x, device=dev)
        sh = mod.build_sharded(params, x, comms, device=dev)
        ref = index.shard(comms)
        out[kind, "build_sharded"] = (
            sh.aux == ref.aux
            and all(torch.equal(a, b) for a, b in
                    zip(sh.stacked + sh.replicated,
                        ref.stacked + ref.replicated)))
        built[kind] = (index, sh, mod.SearchParams(n_probes=8))
    out["build_launches"] = dict(native.LAUNCHES)
    native.reset_launches()
    world = comms.get_size()
    kinds = ("ivf_flat", "ivf_pq") if world == 1 else ("ivf_pq",)
    for kind in kinds:
        index, sh, params = built[kind]
        eng = ServeEngine(sh, K, params, max_batch=256)
        if not eng.is_leader:
            out[kind, "follow"] = eng.follow()
            continue
        eng.warmup(dtypes=(torch.float32, torch.bfloat16))
        out[kind, "served"] = {
            dt: [tuple(r) for r in eng.search(_requests(q, dt))]
            for dt in (torch.float32, torch.bfloat16)}
        eng.close()
        out[kind, "single"] = {dt: _single(index, params, _requests(q, dt))
                               for dt in (torch.float32, torch.bfloat16)}
    if world == 2:
        index, _, params = built["ivf_pq"]
        rep = ann_mnmg.replicate(index, comms, 2)
        eng = ServeEngine(rep, K, params, max_batch=256)
        if eng.is_leader:
            eng.warmup()
            out["replica"] = [tuple(r) for r in eng.search(reqs * 3)]
            out["lanes"] = [eng._router._dispatches.get(
                (eng._engine_id, str(r))) for r in range(2)]
            with faults.plan("comms:op=replica_dispatch:rank=1:raise"):
                out["drained"] = eng.search(reqs * 3)
            out["replica_stats"] = dict(eng.stats)
            eng.close()
            out["replica_single"] = _single(index, params, reqs)
        else:
            out["replica_follow"] = eng.follow()
    out["launches"] = dict(native.LAUNCHES)
    return out


def _run(tmp_path, world, backend):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from raft_tpu_torch.testing.world import run_world

    return run_world("test_torch_cuda_sharded:_battery", world,
                     workdir=tmp_path, backend=backend, device="cuda",
                     timeout=600,
                     sys_path=[str(pathlib.Path(__file__).parent)])


@pytest.fixture(scope="module")
def nccl1(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("nccl1"), 1, "nccl")[0]


@pytest.fixture(scope="module")
def gloo2(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("gloo2"), 2, "gloo")


def _same(a, b):
    for (d, i), (rd, ri) in zip(a, b):
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(i, ri)


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_build_sharded_is_build_then_shard_on_the_card(nccl1, gloo2, kind):
    assert nccl1[kind, "build_sharded"]
    assert all(out[kind, "build_sharded"] for out in gloo2)
    for out in (nccl1, *gloo2):
        launches = out["build_launches"]
        assert launches["fused_l2_nn"] > 0
        assert launches["fused_l2_nn_partials"] > 0


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_world_one_engine_is_single_device_in_both_types(nccl1, kind):
    for dt, served in nccl1[kind, "served"].items():
        _same(served, nccl1[kind, "single"][dt])
    assert nccl1["launches"]["select_k"] > 0
    assert nccl1["launches"]["lut_scan"] > 0


def test_world_two_sharded_engine(gloo2):
    lead, follower = gloo2
    assert follower["ivf_pq", "follow"] == "close"
    for dt, served in lead["ivf_pq", "served"].items():
        _same(served, lead["ivf_pq", "single"][dt])
    for out in gloo2:
        assert out["launches"]["lut_scan"] > 0
        assert out["launches"]["select_k"] > 0


def test_world_two_replica_engine(gloo2):
    lead, follower = gloo2
    assert follower["replica_follow"] == "close"
    _same(lead["replica"], lead["replica_single"] * 3)
    assert all(n > 0 for n in lead["lanes"]), lead["lanes"]
    assert all(isinstance(o, tuple) for o in lead["drained"])
    _same(lead["drained"], lead["replica_single"] * 3)
    st = lead["replica_stats"]
    assert st["replica_faults"] >= 1 and st["replica_reroutes"] > 0
    assert st["dispatch_errors"] == 0
