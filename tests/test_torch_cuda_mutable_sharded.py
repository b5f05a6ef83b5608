"""The mutable index over a sharded main on the card: a world of one over
NCCL (after the same writes, bit for bit the single-device
``MutableIndex`` for both IVF families, and after ``compact()`` bit for
bit a ``build_sharded`` of the live rows; kernel B4's scan mode with the
tombstone bitmap launched for IVF-PQ) and a world of two gloo processes
on the one card (a ``ServeEngine`` over a sharded IVF-PQ mutable index,
rank 0 leading: the leader's writes reach the follower, a compaction
under traffic fails no request, ``close()`` releases the follower).

These tests need an NVIDIA card (marker ``cuda``) and skip without one;
run them with
``python -m pytest --noconftest tests/test_torch_cuda_mutable_sharded.py
-q -m cuda``.
"""

import pathlib
import threading

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

N, D, NQ, K, N_LISTS = 50_000, 32, 512, 10, 64


def _data(device):
    gen = torch.Generator(device=device).manual_seed(5)
    c = torch.randn(64, D, generator=gen, device=device)
    x = c[torch.randint(0, 64, (N,), generator=gen, device=device)] \
        + 0.7 * torch.randn(N, D, generator=gen, device=device)
    q = c[torch.randint(0, 64, (NQ,), generator=gen, device=device)] \
        + 0.7 * torch.randn(NQ, D, generator=gen, device=device)
    return x, q


def _writes(mut, device, seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    mut.upsert(torch.randn(2000, D, generator=gen, device=device),
               np.arange(0, 2000))
    mut.delete(np.arange(3000, 4000))
    mut.upsert(torch.randn(500, D, generator=gen, device=device),
               np.arange(N, N + 500))
    mut.upsert(torch.randn(200, D, generator=gen, device=device),
               np.arange(0, 200))


def _battery(comms, payload):
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors import ann_mnmg, ivf_flat, ivf_pq, mutable
    from raft_tpu_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = comms.device
    x, q = _data(dev)
    out = {}
    world = comms.get_size()
    kinds = ("ivf_flat", "ivf_pq") if world == 1 else ("ivf_pq",)
    for kind in kinds:
        mod = ivf_flat if kind == "ivf_flat" else ivf_pq
        bp = mod.IndexParams(n_lists=N_LISTS)
        sp = mod.SearchParams(n_probes=8)
        index = mod.build(bp, x, device=dev)
        native.reset_launches()
        mut = mutable.MutableIndex(index.shard(comms), x, build_params=bp)
        if world == 1:
            one = mutable.MutableIndex(index, x, build_params=bp)
            _writes(mut, dev)
            _writes(one, dev)
            a = mutable.search(mut, q, K, sp)
            b = mutable.search(one, q, K, sp)
            out[kind, "launches"] = dict(native.LAUNCHES)
            out[kind, "equal"] = all(torch.equal(u, v) for u, v in zip(a, b))
            rows, ids = mut.live_rows()
            mut.compact()
            ref = mod.build_sharded(bp, rows, comms,
                                    ids=torch.as_tensor(ids), device=dev)
            full = mod.SearchParams(n_probes=N_LISTS)
            a = mutable.search(mut, q, K, full)
            b = ann_mnmg.search(ref, q, K, full)
            out[kind, "compacted"] = all(torch.equal(u, v)
                                         for u, v in zip(a, b))
            continue
        eng = ServeEngine(mut, K, sp, max_batch=256)
        if not eng.is_leader:
            out["follow"] = eng.follow()
        else:
            eng.warmup()
            _writes(mut, dev)
            reqs = [q[j:j + 64].cpu() for j in range(0, NQ, 64)]
            failed, stop = [], threading.Event()

            def reader():
                while not stop.is_set():
                    failed.extend(o for o in eng.search(reqs)
                                  if isinstance(o, Exception))

            t = threading.Thread(target=reader)
            t.start()
            out["promoted"] = mutable.Compactor(
                mut, eng, delta_fraction=1e-4, tomb_fraction=1e-4).tick()
            stop.set()
            t.join(120)
            out["failed"] = [repr(e) for e in failed]
            eng.close()
        out["books"] = (mut.size, mut.delta_rows, mut.tombstone_count)
        out["launches"] = dict(native.LAUNCHES)
    return out


def _run(tmp_path, world, backend):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from raft_tpu_torch.testing.world import run_world

    return run_world("test_torch_cuda_mutable_sharded:_battery", world,
                     workdir=tmp_path, backend=backend, device="cuda",
                     timeout=600,
                     sys_path=[str(pathlib.Path(__file__).parent)])


@pytest.fixture(scope="module")
def nccl1(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("nccl1"), 1, "nccl")[0]


@pytest.fixture(scope="module")
def gloo2(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("gloo2"), 2, "gloo")


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_world_one_is_the_single_device_mutable_index(nccl1, kind):
    assert nccl1[kind, "equal"]
    assert nccl1[kind, "compacted"]
    launches = nccl1[kind, "launches"]
    assert launches["select_k"] > 0 and launches["fused_l2_nn"] > 0
    if kind == "ivf_pq":
        assert launches["lut_scan_tombstones"] > 0


def test_world_two_engine_writes_and_compaction(gloo2):
    lead, follower = gloo2
    assert follower["follow"] == "close"
    assert lead["promoted"] and lead["failed"] == []
    assert lead["books"] == follower["books"]
    for out in gloo2:
        # every shard's masked scan; every rank's delta assignment
        assert out["launches"]["lut_scan_tombstones"] > 0
        assert out["launches"]["fused_l2_nn"] > 0
    # the compaction's training runs on the first rank
    assert lead["launches"]["fused_l2_nn_partials"] > 0
